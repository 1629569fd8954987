"""Codec throughput on the current JAX device — ONE JSON line.

    python bench.py

Every stream is checked bit-exact against its input (and the codec-8
device stream against the host encoder's).  The result names the device
it ran on (platform, device_kind, count); times are wall seconds around
work that ends in a host copy of its results (min of 3 after a warm-up
call), so a CPU run measures the CPU.

Fields (doc512 fixture, codec 8 at W=16 R=128 unless named):
  * value / codec8_batch16_pages_per_s — encode_batch of 16 pages plus a
    threaded host decode, pages per second;
  * codec8_single_encode_s / _decode_s — one page through compress.encode
    and codec.decode;
  * corpus64_pages_per_s — 64 pages through encode_archive with the
    checkpoint journal on;
  * codec13_device_encode_s — codec 13 with the device rANS payload;
  * pgm8_device_encode_s — 8 bitplanes through encode_pgm(backend="tpu");
  * codec11_encode_s — BSVD dictionary learning on device + host bit IO;
  * codec10/12/13_host_* — the host codecs, for scale.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "doc512.pbm")


def _best(fn, reps=3):
    """min wall seconds of fn() over reps calls, after one warm-up call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip() or None
    except OSError:
        return None


def main():
    import jax
    from binary_image_compression_tpu import native
    from binary_image_compression_tpu.models import archive, codec, compress
    from binary_image_compression_tpu.utils import compile_cache, pnm

    if native.get_lib() is None:
        sys.exit("native library did not load: the host pack would time "
                 "the pure-Python fallback")
    compile_cache.enable()
    if not os.path.exists(FIXTURE):
        subprocess.run([sys.executable,
                        os.path.join(REPO, "scripts", "gen_fixtures.py")],
                       check=True, capture_output=True)
    img = pnm.read_pbm(FIXTURE)
    rows, cols = img.shape
    dev = jax.devices()[0]
    res = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "card": _card(), "image": [rows, cols]}

    # codec 8, device analysis + native pack
    p8 = codec.CodecParams(codec=8, W=16, R=128, strict=False)
    blob = compress.encode(img, p8)
    assert blob == codec.encode(img, p8), "device stream != host stream"
    assert (codec.decode(blob) == img).all(), "round trip not bit-exact"
    res["codec8_bytes"] = len(blob)
    res["codec8_single_encode_s"] = _best(lambda: compress.encode(img, p8))
    res["codec8_single_decode_s"] = _best(lambda: codec.decode(blob))

    B = 16
    pages = np.stack([np.roll(img, 7 * i + 1, axis=1) for i in range(B)])
    blobs = compress.encode_batch(pages, p8)

    def decode_all():
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
            return list(ex.map(codec.decode, blobs))

    assert all((o == pg).all() for o, pg in zip(decode_all(), pages))
    t_enc = _best(lambda: compress.encode_batch(pages, p8))
    t_dec = _best(decode_all)
    res["codec8_batch16_encode_s"] = t_enc
    res["codec8_batch16_decode_s"] = t_dec
    res["value"] = res["codec8_batch16_pages_per_s"] = B / (t_enc + t_dec)
    res["unit"] = "pages/s (512x512 codec-8 encode + decode)"

    corpus = [np.roll(img, (i * 13) % rows, axis=0) for i in range(64)]
    with tempfile.TemporaryDirectory(dir=REPO) as work:
        journal = os.path.join(work, "corpus.journal")
        t = _best(lambda: archive.encode_archive(
            corpus, p8, batch_size=16, checkpoint=journal), reps=1)
        ab = archive.encode_archive(corpus, p8, batch_size=16)
    for i in (0, 31, 63):
        assert (archive.decode_page(ab, i) == corpus[i]).all()
    res["corpus64_pages_per_s"] = 64 / t
    res["corpus64_ratio"] = len(ab) / (64 * rows * cols / 8)

    # other device paths
    p13 = codec.CodecParams(codec=13, W=0, T=0, R=0)
    b13d = compress.encode_scab(img, p13, entropy="device")
    assert (codec.decode(b13d) == img).all()
    res["codec13_device_bytes"] = len(b13d)
    res["codec13_device_encode_s"] = _best(
        lambda: compress.encode_scab(img, p13, entropy="device"))
    gray = (np.cumsum(img, axis=1) * 7 % 256).astype(np.uint32)
    p10 = codec.CodecParams(codec=10, W=0, T=0, R=0)
    gb = codec.encode_pgm(gray, 255, p10, backend="tpu")
    assert gb == codec.encode_pgm(gray, 255, p10, backend="host")
    assert (codec.decode_pgm(gb)[0] == gray).all()
    res["pgm8_device_encode_s"] = _best(
        lambda: codec.encode_pgm(gray, 255, p10, backend="tpu"))
    p11 = codec.CodecParams(codec=11, W=16, T=0, R=0)
    b11 = codec.encode(img, p11)
    assert (codec.decode(b11) == img).all()
    res["codec11_bytes"] = len(b11)
    res["codec11_encode_s"] = _best(lambda: codec.encode(img, p11))

    # host codecs
    for cid in (10, 12, 13):
        p = codec.CodecParams(codec=cid, W=0, T=0, R=0)
        b = codec.encode(img, p)
        assert (codec.decode(b) == img).all()
        res[f"codec{cid}_host_bytes"] = len(b)
        res[f"codec{cid}_host_encode_s"] = _best(lambda: codec.encode(img, p))
        res[f"codec{cid}_host_decode_s"] = _best(lambda: codec.decode(b))

    sys.stdout.flush()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
