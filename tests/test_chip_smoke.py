"""chip_smoke.py's phases at tiny sizes on the CPU (the script itself
refuses to run without a GPU), and at small sizes on the card (`gpu`)."""

import json

import numpy as np
import pytest

import jax

import chip_smoke
from binary_image_compression_tpu.models import codec

SMALL = codec.CodecParams(codec=8, W=8, R=16, strict=False)


def _pages(n, rows, cols, seed=0):
    from binary_image_compression_tpu.utils import synth
    rng = np.random.RandomState(seed)
    return np.stack([synth.doc_image(rng, rows, cols) for _ in range(n)])


def _gray(n, seed=0):
    rng = np.random.RandomState(seed)
    return (np.cumsum(rng.rand(n, n) < 0.2, axis=1) * 9 % 256).astype(
        np.uint32)


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 2
    assert chip_smoke.main(["--four"]) == 2
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_a4_pages_shape_and_seed():
    from binary_image_compression_tpu.utils import synth
    a = synth.a4_pages(2, seed=3, shape=(200, 150))
    b = synth.a4_pages(2, seed=3, shape=(200, 150))
    assert a.shape == (2, 200, 150) and a.dtype == bool
    assert np.array_equal(a, b) and not np.array_equal(a[0], a[1])
    assert 0.05 < a.mean() < 0.5
    assert synth.A4_300DPI == (3508, 2480)


def test_phase_archive_cpu(tmp_path):
    out = chip_smoke.phase_archive(_pages(3, 48, 70), str(tmp_path), SMALL)
    assert out["pages"] == 3 and out["page0_equals_host"]
    assert out["analysis_memory"]["output_size_in_bytes"] > 0
    json.dumps(out)


def test_phase_cli_cpu(tmp_path):
    out = chip_smoke.phase_cli(_pages(1, 40, 75)[0], str(tmp_path), SMALL)
    assert out["stream_bytes"] > 28
    json.dumps(out)


def test_phase_device_cpu():
    pages = _pages(2, 64, 64)
    out = chip_smoke.phase_device(pages[0], _gray(32), pages[1])
    assert out["codec13"]["bytes"] > 0 and out["codec11"]["bytes"] > 0
    json.dumps(out)


def test_phase_four_cpu():
    out = chip_smoke.phase_four(_pages(1, 64, 96)[0], _pages(4, 32, 48),
                                SMALL)
    assert out["pageshard_devices"] == 4
    json.dumps(out)


@pytest.mark.gpu
def test_phase_archive_gpu(gpu, tmp_path):
    out = chip_smoke.phase_archive(_pages(4, 256, 384), str(tmp_path),
                                   chip_smoke.PARAMS)
    assert out["page0_equals_host"]


@pytest.mark.gpu
def test_phase_cli_gpu(gpu, tmp_path):
    chip_smoke.phase_cli(_pages(1, 256, 384)[0], str(tmp_path),
                         chip_smoke.PARAMS)


@pytest.mark.gpu
def test_phase_device_gpu(gpu):
    pages = _pages(2, 256, 256)
    chip_smoke.phase_device(pages[0], _gray(128), pages[1])


@pytest.mark.gpu
def test_phase_four_gpu(gpu):
    if len(jax.devices("gpu")) < 4:
        pytest.skip("needs 4 GPUs")
    chip_smoke.phase_four(_pages(1, 256, 384)[0], _pages(4, 128, 192),
                          chip_smoke.PARAMS)
