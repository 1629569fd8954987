"""Deterministic synthetic pages: repeated glyph stamps on a text grid,
which give document-like patch-match statistics (the reference's data/
set is not distributed)."""

from __future__ import annotations

import numpy as np

# ISO 216 A4 at 300 dpi, and glyphs of 10-point text at that resolution
A4_300DPI = (3508, 2480)
GLYPH_300DPI = dict(nglyphs=64, gh=32, gw=22)


def doc_image(rng, rows, cols, nglyphs=24, gh=10, gw=7, fill=0.35):
    """Text-document-like binary image: random glyph set stamped on a grid."""
    glyphs = rng.rand(nglyphs, gh, gw) < fill
    img = np.zeros((rows, cols), dtype=bool)
    for y in range(2, rows - gh - 1, gh + 3):
        for x in range(2, cols - gw - 1, gw + 2):
            if rng.rand() < 0.85:  # word spacing
                img[y:y + gh, x:x + gw] = glyphs[rng.randint(nglyphs)]
    return img


def a4_pages(n: int, seed: int = 0, shape=A4_300DPI) -> np.ndarray:
    """n glyph-stamp pages (bool [n, rows, cols]) from one seed; each page
    draws its own glyph set, so pages differ."""
    rng = np.random.RandomState(seed)
    return np.stack([doc_image(rng, *shape, **GLYPH_300DPI)
                     for _ in range(n)])
