"""BSVD golden conformance: learned D/A/E byte-identical with the compiled
reference (same rand48 stream, same update order), plus device-path sanity."""

import hashlib
import io
import json
import os

import numpy as np
import pytest

from binary_image_compression_tpu.utils import pnm
from binary_image_compression_tpu.models import bsvd_ref
from binary_image_compression_tpu.utils.rand48 import Rand48

HERE = os.path.dirname(__file__)
FIX = os.path.join(HERE, "fixtures")
with open(os.path.join(HERE, "goldens", "reference_goldens.json")) as f:
    GOLDENS = json.load(f)

RUNS = [
    ("bsvd_img_mi0_cu0_du0", "text64.pbm",
     dict(W=8, K=16, image_mode=True, mi=0, cu=0, du=0, lm=0)),
    ("bsvd_img_mi1_cu1_du1", "text64.pbm",
     dict(W=8, K=16, image_mode=True, mi=1, cu=1, du=1, lm=0)),
    ("bsvd_img_mi2_cu0_du0", "text64.pbm",
     dict(W=8, K=12, image_mode=True, mi=2, cu=0, du=0, lm=0)),
    ("bsvd_img_mi3_cu0_du1", "text64.pbm",
     dict(W=8, K=12, image_mode=True, mi=3, cu=0, du=1, lm=0)),
    ("bsvd_mat_mi0_cu0_du0", "noise96x80.pbm",
     dict(W=16, K=8, image_mode=False, mi=0, cu=0, du=0, lm=0)),
    ("bsvd_img_alter1", "text64.pbm",
     dict(W=8, K=8, image_mode=True, mi=0, cu=0, du=0, lm=1)),
    ("bsvd_img_alter2", "text64.pbm",
     dict(W=8, K=8, image_mode=True, mi=0, cu=0, du=0, lm=2)),
    ("bsvd_img_seed7", "text64.pbm",
     dict(W=8, K=16, image_mode=True, mi=0, cu=0, du=0, lm=0, seed=7)),
    ("bsvd_img_graphgrow", "text64.pbm",
     dict(W=8, K=8, image_mode=True, mi=4, cu=0, du=0, lm=0)),
    ("bsvd_img_alter3_prox", "text64.pbm",
     dict(W=8, K=8, image_mode=True, mi=0, cu=0, du=1, lm=3)),
]


def _sha(mat):
    buf = io.BytesIO()
    pnm.write_pbm(mat, buf)
    return hashlib.sha256(buf.getvalue()).hexdigest()


@pytest.mark.parametrize("name,image,kw", RUNS, ids=[r[0] for r in RUNS])
def test_bsvd_reference_parity(name, image, kw):
    img = pnm.read_pbm(os.path.join(FIX, image))
    D, A, E, wE, res_img = bsvd_ref.run_bsvd_test(img, **kw)
    g = GOLDENS[name]
    assert wE == g["final_E_weight"]
    assert _sha(D) == g["dictionary_sha"]
    assert _sha(A) == g["coefficients_sha"]
    assert _sha(res_img if res_img is not None else E) == g["residual_sha"]


def test_rand48_matches_gsl_semantics():
    # the stream must be the drand48 LCG: cross-check a few invariants
    r = Rand48(34503498)
    a = [r.get() for _ in range(4)]
    r2 = Rand48(34503498)
    assert [r2.get() for _ in range(4)] == a      # deterministic
    assert all(0 <= v <= 0xFFFFFFFF for v in a)
    r3 = Rand48(0)                                 # default-seed path
    assert r3.get() != Rand48(1).get()


def test_mdl_learning_loops_run():
    """MDL forward/backward selection (bsvd.cpp:1463-1663 capability)."""
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    out = bsvd_ref.run_mdl(img, W=8, K0=4, image_mode=True,
                           direction="forward", max_steps=3)
    assert out["bestL"] > 0
    out = bsvd_ref.run_mdl(img, W=8, K0=8, image_mode=True,
                           direction="backward", max_steps=3)
    assert out["bestL"] > 0
