"""Round-trip fuzzing across shapes, densities, and codec parameters."""

import numpy as np
import pytest

from binary_image_compression_tpu.models import codec


CASES = []
_r = np.random.RandomState(987)
for _ in range(14):
    rows = int(_r.randint(1, 90))
    cols = int(_r.randint(1, 90))
    dens = float(_r.choice([0.01, 0.1, 0.5, 0.9, 0.99]))
    W = int(_r.choice([4, 8, 16]))
    R = int(_r.choice([8, 16, 64]))
    cid = int(_r.choice([3, 4, 7, 8, 10]))
    strict = bool(_r.randint(2))
    CASES.append((rows, cols, dens, W, R, cid, strict))


@pytest.mark.parametrize("rows,cols,dens,W,R,cid,strict", CASES)
def test_fuzz_roundtrip(rows, cols, dens, W, R, cid, strict):
    rng = np.random.RandomState(rows * 1000 + cols)
    img = rng.rand(rows, cols) < dens
    p = codec.CodecParams(codec=cid, W=W, R=R, strict=strict)
    blob = codec.encode(img, p)
    np.testing.assert_array_equal(codec.decode(blob), img)
    # python decode agrees with native decode
    np.testing.assert_array_equal(codec.decode(blob, use_native=False), img)


def test_fuzz_codec1_roundtrip():
    """codec 1 (full-prior-area search) on small shapes — its search is
    O(rows*cols*W^2) per tile by construction, like the reference's."""
    rng = np.random.RandomState(31)
    for _ in range(6):
        rows = int(rng.randint(1, 50))
        cols = int(rng.randint(1, 50))
        W = int(rng.choice([4, 8, 16]))
        img = rng.rand(rows, cols) < float(rng.choice([0.05, 0.5, 0.95]))
        blob = codec.encode(img, codec.CodecParams(codec=1, W=W))
        np.testing.assert_array_equal(codec.decode(blob), img)


def test_fuzz_structured_images():
    rng = np.random.RandomState(5)
    for _ in range(4):
        img = np.zeros((100, 130), dtype=bool)
        for _ in range(20):  # random rectangles
            y, x = rng.randint(0, 90), rng.randint(0, 120)
            img[y:y + rng.randint(2, 10), x:x + rng.randint(2, 10)] = True
        for cid in (8, 10):
            p = codec.CodecParams(codec=cid, W=16, R=32)
            np.testing.assert_array_equal(
                codec.decode(codec.encode(img, p)), img)


def test_fuzz_pgm(rng):
    for maxval in (3, 255, 4095):
        gray = rng.randint(0, maxval + 1, (40, 52)).astype(np.uint32)
        blob = codec.encode_pgm(gray, maxval,
                                codec.CodecParams(codec=10, W=0))
        back, mv = codec.decode_pgm(blob)
        np.testing.assert_array_equal(back, gray)
        assert mv == maxval


def test_fuzz_fused_kernel_matches_host():
    """Device analysis == host encoder across awkward geometries:
    R wider than the image, single-tile rows/cols, ragged edges."""
    import numpy as np
    from binary_image_compression_tpu.models import codec, compress
    rng = np.random.RandomState(11)
    cases = [(8, 8, 24, 17), (8, 16, 17, 90), (16, 16, 40, 40),
             (8, 64, 60, 44), (16, 128, 48, 33), (8, 32, 7, 7)]
    for W, R, rows, cols in cases:
        img = rng.rand(rows, cols) < rng.choice([0.1, 0.4])
        for cid in (8, 4):
            p = codec.CodecParams(codec=cid, W=W, R=R, strict=False)
            dev = compress.encode(img, p)
            assert dev == codec.encode(img, p), (W, R, rows, cols, cid)
            assert (codec.decode(dev) == img).all()
