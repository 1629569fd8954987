"""Grayscale <-> bitplane decomposition (device-vectorized bitplane_tool path).

Replaces the two reference CLI tools as library functions:
  * bitplane_tool.cpp:24-39 — PGM -> one PBM per bitplane (mask b <<= 1 while
    b < maxval).  The reference tool also has a (rows, cols) argument-order
    bug against read_pgm_data's (ancho, alto) signature that silently breaks
    non-square images (bitplane_tool.cpp:22 vs pnm.h:10); fixed here.
  * plane2pgm_tool.cpp:32-52 — OR per-plane masks back into a PGM.

Both directions are single vectorized shift/mask expressions and run under
jit on packed planes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops import bitpack


def nplanes_for_maxval(maxval: int) -> int:
    """Number of planes the reference tool emits: #{b = 1,2,4,... : b < maxval}."""
    n = 0
    b = 1
    while b < maxval:
        n += 1
        b <<= 1
    return n


def decompose(gray: np.ndarray, maxval: int) -> np.ndarray:
    """uint [rows, cols] -> bool [nplanes, rows, cols], LSB plane first."""
    gray = np.asarray(gray, dtype=np.uint32)
    n = nplanes_for_maxval(maxval)
    shifts = np.arange(n, dtype=np.uint32).reshape(-1, 1, 1)
    return ((gray[None] >> shifts) & 1).astype(bool)


def recompose(planes: np.ndarray) -> np.ndarray:
    """bool [nplanes, rows, cols] -> uint32 [rows, cols] (LSB plane first)."""
    planes = np.asarray(planes)
    shifts = np.arange(planes.shape[0], dtype=np.uint32).reshape(-1, 1, 1)
    return (planes.astype(np.uint32) << shifts).sum(axis=0, dtype=np.uint32)


def decompose_packed(gray: jnp.ndarray, maxval: int) -> jnp.ndarray:
    """jit path: uint32 gray [rows, cols] -> packed planes [n, rows, w]."""
    n = nplanes_for_maxval(maxval)
    shifts = jnp.arange(n, dtype=jnp.uint32).reshape(-1, 1, 1)
    bits = (jnp.asarray(gray, jnp.uint32)[None] >> shifts) & 1
    return bitpack.pack(bits)


def recompose_packed(planes_packed: jnp.ndarray, cols: int) -> jnp.ndarray:
    bits = bitpack.unpack(planes_packed, cols).astype(jnp.uint32)
    n = bits.shape[0]
    shifts = jnp.arange(n, dtype=jnp.uint32).reshape(-1, 1, 1)
    return (bits << shifts).sum(axis=0, dtype=jnp.uint32)
