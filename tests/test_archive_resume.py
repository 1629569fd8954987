"""Elastic corpus encode: checkpoint journal + mid-run kill + resume
(VERDICT r3 item 10; BASELINE configs #4/#5 imply hour-scale corpus runs).

A subprocess encodes a corpus with `checkpoint=` and hard-kills itself
(os._exit — no cleanup, no atexit, the closest in-process stand-in for
SIGKILL) after two batches.  The resumed run must (a) actually resume —
re-encode only the missing pages — and (b) produce an archive byte-identical
to an uninterrupted encode.
"""

import os
import struct
import subprocess
import sys

import numpy as np

from binary_image_compression_tpu.models import archive, codec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PARAMS = dict(codec=8, W=8, R=16, strict=False)
N_PAGES, BATCH = 12, 2


def _corpus():
    rng = np.random.RandomState(3)
    return [(rng.rand(32, 32) < 0.3) for _ in range(N_PAGES)]


KILLER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, os.environ["BIC_REPO"])
from binary_image_compression_tpu.models import archive, codec

rng = np.random.RandomState(3)
pages = [(rng.rand(32, 32) < 0.3) for _ in range(12)]
params = codec.CodecParams(codec=8, W=8, R=16, strict=False)

def die_after_two(n_done):
    if n_done >= 4:        # two finished batches of 2 are on disk
        os._exit(9)        # hard death: no cleanup, journal stays as-is

archive.encode_archive(pages, params, batch_size=2,
                       checkpoint=os.environ["BIC_CKPT"],
                       on_progress=die_after_two)
os._exit(0)  # must be unreachable
"""


def test_kill_and_resume_byte_identical(tmp_path):
    pages = _corpus()
    params = codec.CodecParams(**PARAMS)
    expected = archive.encode_archive(pages, params, batch_size=BATCH)

    ckpt = str(tmp_path / "corpus.journal")
    script = tmp_path / "killer.py"
    script.write_text(KILLER)
    env = dict(os.environ, BIC_REPO=REPO, BIC_CKPT=ckpt)
    env["JAX_PLATFORMS"] = "cpu"   # a child never touches the card
    r = subprocess.run([sys.executable, str(script)], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 9, (r.returncode, r.stdout, r.stderr)
    assert os.path.exists(ckpt), "journal must survive the kill"

    # resume: only the missing pages are re-encoded
    batches = []
    blob = archive.encode_archive(pages, params, batch_size=BATCH,
                                  checkpoint=ckpt,
                                  on_progress=batches.append)
    assert blob == expected, "resumed archive differs from uninterrupted"
    assert not os.path.exists(ckpt), "journal consumed on success"
    assert batches and batches[0] >= 4 + BATCH and \
        len(batches) <= (N_PAGES - 4) // BATCH, batches
    for i in (0, N_PAGES // 2, N_PAGES - 1):
        assert (archive.decode_page(blob, i) == pages[i]).all()


def test_truncated_tail_record_discarded(tmp_path):
    """A crash mid-append leaves a half-written record; resume must drop it
    and still finish byte-identical."""
    pages = _corpus()
    params = codec.CodecParams(**PARAMS)
    expected = archive.encode_archive(pages, params, batch_size=BATCH)

    ckpt = str(tmp_path / "corpus.journal")
    fp = archive._corpus_fingerprint(pages, params)
    blob0 = codec.encode(pages[0], params)
    archive._journal_append(ckpt, fp, {0: blob0})
    with open(ckpt, "ab") as f:  # record 1 cut off mid-payload
        blob1 = codec.encode(pages[1], params)
        f.write(struct.pack("<II", 1, len(blob1)) + blob1[: len(blob1) // 2])

    done = archive._journal_read(ckpt, fp)
    assert done == {0: blob0}
    blob = archive.encode_archive(pages, params, batch_size=BATCH,
                                  checkpoint=ckpt)
    assert blob == expected


def test_fingerprint_mismatch_ignores_journal(tmp_path):
    """A journal from different params/corpus must not poison a run."""
    pages = _corpus()
    params = codec.CodecParams(**PARAMS)
    other = codec.CodecParams(codec=8, W=8, R=8, strict=False)
    ckpt = str(tmp_path / "corpus.journal")
    fp_other = archive._corpus_fingerprint(pages, other)
    archive._journal_append(ckpt, fp_other, {0: b"not a real blob"})
    blob = archive.encode_archive(pages, params, batch_size=BATCH,
                                  checkpoint=ckpt)
    assert blob == archive.encode_archive(pages, params, batch_size=BATCH)
    for i in range(N_PAGES):
        assert (archive.decode_page(blob, i) == pages[i]).all()
