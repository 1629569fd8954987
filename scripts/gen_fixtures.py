"""Generate deterministic synthetic test images (the reference's data/ is not
in the mount; SURVEY.md §4 fixtures note).  Document-like PBMs (repeated
glyph stamps -> realistic patch-match statistics), noise PBMs at several
densities, and a textured PGM for the bitplane path."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from binary_image_compression_tpu.utils import pnm  # noqa: E402
from binary_image_compression_tpu.utils.synth import doc_image  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures")


def main():
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.RandomState(20260817)

    pnm.write_pbm(doc_image(rng, 64, 64), f"{OUT}/text64.pbm")
    pnm.write_pbm(doc_image(rng, 256, 256), f"{OUT}/text256.pbm")
    pnm.write_pbm(doc_image(rng, 512, 512), f"{OUT}/doc512.pbm")
    pnm.write_pbm(rng.rand(96, 80) < 0.3, f"{OUT}/noise96x80.pbm")
    pnm.write_pbm(rng.rand(128, 128) < 0.05, f"{OUT}/sparse128.pbm")
    # ragged width (not byte-aligned) exercises the partial-byte PBM path
    pnm.write_pbm(doc_image(rng, 75, 101), f"{OUT}/ragged75x101.pbm")

    # textured grayscale (square: bitplane_tool has a square-only arg bug)
    y, x = np.mgrid[0:64, 0:64]
    gray = (96 + 64 * np.sin(x / 6.0) + 48 * np.cos(y / 9.0)
            + rng.randint(-20, 20, (64, 64))).clip(0, 255).astype(np.uint32)
    pnm.write_pgm(gray, 255, f"{OUT}/gray64.pgm")

    print("fixtures written to", os.path.abspath(OUT))


if __name__ == "__main__":
    main()
