"""Smoke run of the codec-8 archive path on the GPU, through the entry
points a user calls, at a real page size.

    python chip_smoke.py           # one card: archive, CLI, other device paths
    python chip_smoke.py --four    # four cards: tile- and page-sharded encode

Pages are A4 at 300 dpi (2480 x 3508, ISO 216) made by the glyph-stamp
generator from a fixed seed; codec 8 with W=16, R=128.  Phases, each
compared with its plain reference:

  archive  encode_archive (journal on) + decode_archive of 16 pages: every
           page decodes bit-exact, page 0's stream equals the host encoder's
  cli      `bic compress` + `bic decompress` of one page, in-process
  device   codec 13 device entropy, encode_pgm(backend="tpu"), codec 11 —
           each equal to the same jitted code placed on the CPU device, and
           decoded on the host
  four     (--four only) the tile-sharded encode of one page and the
           page-sharded analysis of 8 pages on a data=4 mesh, equal to the
           single-card results

Prints one JSON line per phase, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}.  Any failure raises: the exit code
is then nonzero and no result line is printed.  Exits 2 when JAX finds no
GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

from binary_image_compression_tpu import native
from binary_image_compression_tpu.models import archive, codec, compress
from binary_image_compression_tpu.utils import compile_cache, synth

PARAMS = codec.CodecParams(codec=8, W=16, R=128, strict=False)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def _peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _memory(compiled):
    mem = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(mem, k, None) for k in keys}


def _twice(fn):
    """(result, first-call seconds, warm seconds) of fn()."""
    t0 = time.perf_counter()
    out = fn()
    t1 = time.perf_counter()
    again = fn()
    t2 = time.perf_counter()
    return out, again, t1 - t0, t2 - t1


def analysis_step(page, params=PARAMS):
    """The compiled analysis step one page takes."""
    rows, cols = page.shape
    return compress.encode_analyze_packed.lower(
        jnp.asarray(compress._packed_grid(page, params.W)), W=params.W,
        R=params.R, T_thresh=params.resolved_T(), rows=rows,
        cols=cols).compile()


def phase_archive(pages, workdir, params=PARAMS):
    journal = os.path.join(workdir, "corpus.journal")
    enc = lambda: archive.encode_archive(pages, params, checkpoint=journal)
    blob, blob2, first, warm = _twice(enc)
    assert blob2 == blob, "second encode differs"
    assert not os.path.exists(journal), "journal left behind"
    t0 = time.perf_counter()
    back = archive.decode_archive(blob)
    t_dec = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(back, pages)):
        assert np.array_equal(a, b), f"page {i} does not decode bit-exact"
    t0 = time.perf_counter()
    host = codec.encode(pages[0], params)
    t_host = time.perf_counter() - t0
    assert archive.page_stream(blob, 0) == host, \
        "page 0 stream differs from the host encoder's"
    compiled = analysis_step(pages[0], params)
    n = len(pages)
    raw = sum(p.size // 8 for p in pages)
    return dict(phase="archive", pages=n, shape=list(pages[0].shape),
                first_call_seconds=first, warm_seconds=warm,
                compile_seconds=first - warm, pages_per_s=n / warm,
                decode_seconds=t_dec, decode_pages_per_s=n / t_dec,
                host_encode_page_seconds=t_host, archive_bytes=len(blob),
                ratio=len(blob) / raw, page0_equals_host=True,
                analysis_memory=_memory(compiled),
                peak_bytes_in_use=_peak_bytes(jax.devices()[0]))


def phase_cli(page, workdir, params=PARAMS):
    from binary_image_compression_tpu import cli
    from binary_image_compression_tpu.utils import pnm
    src = os.path.join(workdir, "page.pbm")
    enc = os.path.join(workdir, "page.bic")
    out = os.path.join(workdir, "back.pbm")
    pnm.write_pbm(page, src)
    opts = ["-W", str(params.W), "-R", str(params.R)]
    _, _, first, warm = _twice(lambda: cli.main(["compress", src, enc]
                                                + opts))
    t0 = time.perf_counter()
    cli.main(["decompress", enc, out])
    t_dec = time.perf_counter() - t0
    with open(src, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read(), "decompressed PBM differs from input"
    return dict(phase="cli", shape=list(page.shape),
                compress_first_seconds=first, compress_warm_seconds=warm,
                decompress_seconds=t_dec, pages_per_s=1.0 / warm,
                stream_bytes=os.path.getsize(enc))


def _on_cpu(fn):
    with jax.default_device(jax.devices("cpu")[0]):
        return fn()


def phase_device(page, gray, bsvd_page):
    """Codec 13 device entropy, the device bitplane path and codec 11:
    each on the default device against the same code on the CPU device,
    and decoded on the host."""
    out = dict(phase="device")
    p13 = codec.CodecParams(codec=13, W=0, T=0, R=0)
    b13, _, first, warm = _twice(
        lambda: compress.encode_scab(page, p13, entropy="device"))
    assert b13 == _on_cpu(lambda: compress.encode_scab(
        page, p13, entropy="device")), "codec 13: device != cpu"
    assert np.array_equal(codec.decode(b13), page), "codec 13 round trip"
    out["codec13"] = dict(shape=list(page.shape), first_seconds=first,
                          warm_seconds=warm, pages_per_s=1.0 / warm,
                          bytes=len(b13))

    maxval = 255
    pgm = lambda: codec.encode_pgm(gray, maxval, backend="tpu")
    bg, _, first, warm = _twice(pgm)
    assert bg == _on_cpu(pgm), "encode_pgm: device != cpu"
    back, mv = codec.decode_pgm(bg)
    assert mv == maxval and np.array_equal(back, gray), "pgm round trip"
    out["pgm"] = dict(shape=list(gray.shape), first_seconds=first,
                      warm_seconds=warm, bytes=len(bg))

    p11 = codec.CodecParams(codec=11, W=16, T=0, R=0)
    b11, _, first, warm = _twice(lambda: codec.encode(bsvd_page, p11))
    assert b11 == _on_cpu(lambda: codec.encode(bsvd_page, p11)), \
        "codec 11: device != cpu"
    with jax.default_matmul_precision("highest"):
        assert b11 == codec.encode(bsvd_page, p11), \
            "codec 11: default matmul precision != highest"
    assert np.array_equal(codec.decode(b11), bsvd_page), "codec 11 trip"
    out["codec11"] = dict(shape=list(bsvd_page.shape), first_seconds=first,
                          warm_seconds=warm, bytes=len(b11))
    out["peak_bytes_in_use"] = _peak_bytes(jax.devices()[0])
    return out


def phase_four(page, pages, params=PARAMS, n=4):
    """Tile-sharded encode of one page and page-sharded analysis of a batch
    on a data=n mesh, each equal to the single-device result."""
    from binary_image_compression_tpu.parallel import mesh as pmesh
    from binary_image_compression_tpu.parallel import tileshard
    m = pmesh.make_mesh(n, data=n, model=1)
    blob, _, first, warm = _twice(
        lambda: tileshard.encode_tile_sharded(m, page, params))
    single = compress.encode(page, params)
    assert blob == single, "tile-sharded stream != single-device stream"

    B, rows, cols = pages.shape
    W = params.W
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((B, ny * W, nx * W), np.int8)
    grid[:, :rows, :cols] = pages
    kw = dict(W=W, R=params.R, T_thresh=params.resolved_T(), rows=rows,
              cols=cols)
    run = pmesh.sharded_encode_analyze(m, **kw)
    res, _, pfirst, pwarm = _twice(
        lambda: jax.block_until_ready(run(jnp.asarray(grid))))
    devices = {s.device for s in res["rank"].addressable_shards}
    assert len(devices) == n, f"page shards landed on {len(devices)} devices"
    got = jax.device_get(res)
    dev0 = jax.devices()[0]
    for b in range(B):
        want = jax.device_get(compress.encode_analyze(
            jax.device_put(grid[b], dev0), **kw))
        for k in want:
            assert np.array_equal(got[k][b], want[k]), f"page {b} {k}"
    return dict(phase="four", devices=n, shape=[rows, cols],
                tileshard_first_seconds=first, tileshard_warm_seconds=warm,
                tileshard_equals_single=True, pageshard_pages=B,
                pageshard_first_seconds=pfirst,
                pageshard_warm_seconds=pwarm,
                pageshard_pages_per_s=B / pwarm,
                pageshard_devices=len(devices),
                pageshard_equals_single=True,
                peak_bytes_in_use=[_peak_bytes(d) for d in jax.devices()[:n]])


def card_lines() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform}", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devs) < need:
        print(f"needs {need} GPUs, found {len(devs)}", file=sys.stderr)
        return 2
    if native.get_lib() is None:
        print("native library did not load", file=sys.stderr)
        return 3
    emit(phase="setup", compile_cache=compile_cache.enable(),
         device_kind=devs[0].device_kind, devices=len(devs))
    card = card_lines()

    with tempfile.TemporaryDirectory() as work:
        if args.four:
            pages = synth.a4_pages(8, seed=args.seed)
            emit(**phase_four(pages[0], pages))
            count = 4
        else:
            pages = synth.a4_pages(16, seed=args.seed)
            emit(**phase_archive(pages, work))
            emit(**phase_cli(pages[1], work))
            rng = np.random.RandomState(args.seed)
            y, x = np.mgrid[0:1024, 0:1024]
            gray = ((128 + 60 * np.sin(x / 17.0) + 50 * np.cos(y / 23.0)
                     + rng.randint(-12, 12, (1024, 1024)))
                    .clip(0, 255).astype(np.uint32))
            emit(**phase_device(pages[2], gray, pages[3][:512, :512]))
            count = 1
    print(card, flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
