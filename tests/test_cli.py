"""CLI end-to-end: compress/decompress round-trips, tool parity."""

import os
import subprocess
import sys

import numpy as np
import pytest

from binary_image_compression_tpu.utils import pnm

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, cwd):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-m",
                           "binary_image_compression_tpu"] + args,
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_pbm_roundtrip(tmp_path):
    src = os.path.join(FIX, "text64.pbm")
    r = run_cli(["compress", src, "t.bic", "-W", "8", "-R", "32",
                 "--backend", "host"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = run_cli(["decompress", "t.bic", "t.pbm"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert open(src, "rb").read() == open(tmp_path / "t.pbm", "rb").read()


def test_cli_pgm_roundtrip(tmp_path):
    src = os.path.join(FIX, "gray64.pgm")
    r = run_cli(["compress", src, "g.bic", "-W", "16"], tmp_path)
    assert r.returncode == 0, r.stderr
    r = run_cli(["decompress", "g.bic", "g.pgm"], tmp_path)
    assert r.returncode == 0, r.stderr
    a, am = pnm.read_pnm(src)
    b, bm = pnm.read_pnm(tmp_path / "g.pgm")
    assert (a == b).all() and am == bm


def test_cli_bitplane_tools(tmp_path):
    src = os.path.join(FIX, "gray64.pgm")
    r = run_cli(["bitplanes", src], tmp_path)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "plane_07.pbm").exists()
    r = run_cli(["planes2pgm", "plane_", "rec.pgm"], tmp_path)
    assert r.returncode == 0, r.stderr
    a, _ = pnm.read_pnm(src)
    b, _ = pnm.read_pnm(tmp_path / "rec.pgm")
    assert (a == b).all()


def test_cli_bsvd_and_estimate(tmp_path):
    src = os.path.join(FIX, "text64.pbm")
    r = run_cli(["bsvd", src, "-w", "8", "-k", "8", "-I", "1"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "|E| =" in r.stdout
    assert (tmp_path / "dictionary.pbm").exists()
    r = run_cli(["estimate", src, "--driver", "8", "-W", "8", "-R", "32"],
                tmp_path)
    assert r.returncode == 0, r.stderr
    assert "comp_bytes" in r.stdout


def test_cli_info(tmp_path):
    src = os.path.join(FIX, "text64.pbm")
    run_cli(["compress", src, "t.bic", "-W", "8", "--backend", "host"],
            tmp_path)
    r = run_cli(["info", "t.bic"], tmp_path)
    assert r.returncode == 0
    assert '"BIC1"' in r.stdout


def test_cli_pgm_default_uses_auto_selection(tmp_path):
    """`bic compress x.pgm` without codec flags must auto-select per plane
    (regression: an int-vs-str comparison made the explicit-flags check
    always true, silently forcing codec-8 params)."""
    import subprocess
    import sys
    import numpy as np
    from binary_image_compression_tpu.models import codec
    from binary_image_compression_tpu.utils import pnm
    rng = np.random.RandomState(3)
    gray = (np.abs(np.cumsum(rng.randn(64, 64), axis=1)) * 9).astype(
        np.uint32) % 256
    src = tmp_path / "g.pgm"
    out = tmp_path / "g.bicg"
    pnm.write_pgm(gray, 255, str(src))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    subprocess.run([sys.executable, "-m", "binary_image_compression_tpu",
                    "compress", str(src), str(out)], check=True, env=env,
                   capture_output=True)
    expect = codec.encode_pgm(gray, 255, None)   # per-plane best-of
    assert out.read_bytes() == expect


def test_tpu_encoders_reject_bad_W():
    import numpy as np
    import pytest as _pytest
    from binary_image_compression_tpu.models import codec, compress
    img = np.zeros((32, 32), bool)
    for W in (0, 65):
        with _pytest.raises(ValueError, match="out of range"):
            compress.encode(img, codec.CodecParams(codec=8, W=W,
                                                   strict=False))
        with _pytest.raises(ValueError, match="out of range"):
            compress.encode_batch(img[None], codec.CodecParams(
                codec=8, W=W, strict=False))


def test_cli_shard_tiles_stream_parity(tmp_path):
    """`bic compress --shard tiles` routes through the tile-sharded analyzer
    (multi-hop ppermute halo over the virtual 8-device mesh) and must emit
    the SAME bytes as the unsharded encoder (BASELINE config #4)."""
    src = os.path.join(FIX, "text64.pbm")
    env_extra = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    import subprocess
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           **env_extra}
    r = subprocess.run([sys.executable, "-m",
                        "binary_image_compression_tpu", "compress", src,
                        "sharded.bic", "-W", "8", "-R", "32",
                        "--shard", "tiles"],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    r2 = run_cli(["compress", src, "plain.bic", "-W", "8", "-R", "32",
                  "--backend", "host"], tmp_path)
    assert r2.returncode == 0, r2.stderr
    assert open(tmp_path / "sharded.bic", "rb").read() == \
        open(tmp_path / "plain.bic", "rb").read()
    r3 = run_cli(["decompress", "sharded.bic", "out.pbm"], tmp_path)
    assert r3.returncode == 0, r3.stderr
    assert open(src, "rb").read() == open(tmp_path / "out.pbm", "rb").read()


def test_cli_codec13_device_entropy(tmp_path):
    """--codec 13 --entropy device writes a mode-2 (device rANS) stream
    that decompresses bit-exactly through the standard decode path."""
    src = os.path.join(FIX, "text256.pbm")
    out = tmp_path / "t.bic"
    back = tmp_path / "t.pbm"
    r = run_cli(["compress", src, str(out), "--codec", "13",
                 "--entropy", "device"], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    blob = out.read_bytes()
    assert blob[28 + 1] == 2        # payload mode byte after BIC1 header
    r = run_cli(["decompress", str(out), str(back)], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert back.read_bytes() == open(src, "rb").read()
