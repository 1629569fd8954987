"""Where the time of a codec-8 page batch goes on the GPU, at A4 300 dpi.

    python scripts/profile_encode.py [--pages N] [--reps N] [--trace DIR]

Checks that page 0's device stream equals the host encoder's, then times
the layers of encode_batch one by one: the compiled analysis step per page,
the fetch of one page's outputs, the native host decision + pack of one
page, and encode_batch of a 16-page batch (pages/s, median of --reps).
--trace writes a profiler trace of one warm batch to DIR and prints the
device busy share and the device ops that took the most time.  One JSON
line per measurement.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from binary_image_compression_tpu import native  # noqa: E402
from binary_image_compression_tpu.models import codec, compress  # noqa: E402
from binary_image_compression_tpu.utils import compile_cache, synth  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def timed(fn, reps):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return ts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pages", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", default="")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("needs a GPU")
    if native.get_lib() is None:
        sys.exit("native library did not load")
    compile_cache.enable()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    emit(card=card, device=dev.device_kind)

    pages = synth.a4_pages(args.pages, seed=1)
    rows, cols = pages.shape[1:]
    p = codec.CodecParams(codec=8, W=16, R=128, strict=False)
    M = p.W * p.W
    grids = [jnp.asarray(compress._packed_grid(pg, p.W)) for pg in pages]
    t0 = time.perf_counter()
    step = compress.encode_analyze_packed.lower(
        grids[0], W=p.W, R=p.R, T_thresh=p.resolved_T(), rows=rows,
        cols=cols).compile()
    out = jax.device_get(step(grids[0]))
    mem = step.memory_analysis()
    emit(phase="compile", seconds=time.perf_counter() - t0,
         temp_bytes=getattr(mem, "temp_size_in_bytes", None))

    hdr = codec._header(p, rows, cols, codec.image_crc(pages[0]))
    T = out["rank"].shape[0]
    t0 = time.perf_counter()
    host = codec.encode(pages[0], p)
    same = compress._assemble(out, hdr, M, T) == host
    emit(phase="check", host_encode_seconds=time.perf_counter() - t0,
         stream_equals_host=same)
    if not same:
        sys.exit("device stream != host stream")

    def analyze_all():
        jax.block_until_ready([step(g) for g in grids])

    def fetch_once():
        o = step(grids[0])
        jax.block_until_ready(o)
        t0 = time.perf_counter()
        jax.device_get(o)
        return time.perf_counter() - t0

    emit(phase="layers", tiles=T,
         analysis_ms_per_page=[t * 1e3 / len(grids)
                               for t in timed(analyze_all, args.reps)],
         fetch_ms=[fetch_once() * 1e3 for _ in range(args.reps)],
         host_decide_pack_ms=[t * 1e3 for t in timed(
             lambda: compress._assemble(out, hdr, M, T), args.reps)])

    batch = synth.a4_pages(16, seed=2)
    compress.encode_batch(batch, p)                           # warm
    rates = [len(batch) / t for t in timed(
        lambda: compress.encode_batch(batch, p), args.reps)]
    emit(phase="encode_batch", pages=len(batch), pages_per_s=rates,
         median_pages_per_s=float(np.median(rates)))
    if args.trace:
        trace(batch, p, args.trace)
    emit(phase="done", peak_bytes_in_use=dev.memory_stats().get(
        "peak_bytes_in_use"))


def trace(batch, p, logdir):
    """Device busy share and the top device ops over one warm batch."""
    from jax.profiler import ProfileData
    shutil.rmtree(logdir, ignore_errors=True)
    jax.profiler.start_trace(logdir)
    t0 = time.perf_counter()
    compress.encode_batch(batch, p)
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    path = glob.glob(os.path.join(logdir, "plugins/profile/*/*.xplane.pb"))
    for plane in ProfileData.from_file(path[0]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        iv, by_name = [], {}
        for line in plane.lines:
            for ev in line.events:
                iv.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                by_name[ev.name] = by_name.get(ev.name, 0) + ev.duration_ns
        iv.sort()
        busy, end = 0.0, -1.0
        for a, b in iv:
            if b > end:
                busy += b - max(a, end)
                end = b
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        emit(phase="trace", plane=plane.name, wall_seconds=wall,
             device_busy_seconds=busy * 1e-9,
             busy_share_of_wall=busy * 1e-9 / wall,
             top=[(k[:80], v * 1e-9) for k, v in top])


if __name__ == "__main__":
    main()
