"""Bit-packed boolean matrix algebra over uint32 lanes (device binmat).

This is the device re-design of the reference's ``binary_matrix`` core
(reference: binmat.h:29-234, binmat.cpp) — NOT a port.  Matrices are
``uint32[..., rows, ceil(cols/32)]`` arrays, MSB-first within each word so a
packed row is byte-compatible with PBM P4 raster lines (reference bit order:
binmat.h:17 ``MSB = 1 << 63``; we use 32-bit lanes, the accelerator's native word).

All ops are pure functions, jit-friendly, and support arbitrary leading batch
dimensions.  Reductions use ``lax.population_count`` (the VPU popcount); GF(2)
matrix products are 0/1 float matmuls reduced mod 2
(reference: binmat.cpp:516-616 ``mul_AB/AtB/ABt`` — and we also implement
``mul_AtBt``, which is an empty stub at binmat.cpp:596).

Reference defects intentionally fixed here (SURVEY.md §2.1):
  * ``col_weight`` undercount (binmat.cpp:87 loop bound bug) — ours is exact.
  * ``get_transposed`` shape bug for non-square (binmat.cpp:199-214).
  * ``block_sum`` OpenMP race (binmat.cpp:49-52) — irrelevant under JAX.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

LANE = 32  # bits per packed word
_SHIFTS = tuple(range(LANE - 1, -1, -1))  # MSB-first bit order within a word


def nwords(cols: int) -> int:
    """Number of uint32 lanes needed for `cols` bits."""
    return -(-cols // LANE)


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def pack(bits) -> jnp.ndarray:
    """Pack a boolean/0-1 array [..., cols] into uint32 [..., nwords(cols)].

    Bit j of the input lands in word j // 32 at position 31 - (j % 32)
    (MSB-first), matching PBM P4 byte order when the words are serialized
    big-endian.
    """
    bits = jnp.asarray(bits)
    cols = bits.shape[-1]
    w = nwords(cols)
    pad = w * LANE - cols
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    bits = bits.reshape(bits.shape[:-1] + (w, LANE)).astype(jnp.uint32)
    shifts = jnp.array(_SHIFTS, dtype=jnp.uint32)
    return (bits << shifts).sum(axis=-1, dtype=jnp.uint32)


def unpack(packed, cols: int) -> jnp.ndarray:
    """Unpack uint32 [..., w] into a boolean array [..., cols]."""
    packed = jnp.asarray(packed, dtype=jnp.uint32)
    shifts = jnp.array(_SHIFTS, dtype=jnp.uint32)
    bits = (packed[..., None] >> shifts) & jnp.uint32(1)
    bits = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * LANE,))
    return bits[..., :cols].astype(jnp.bool_)


def trail_mask(cols: int) -> np.ndarray:
    """uint32[w] mask with ones in valid bit positions (ragged last word).

    Reference analog: ``trail_mask`` member (binmat.h:231, binmat.cpp:140-161).
    """
    w = nwords(cols)
    m = np.full(w, 0xFFFFFFFF, dtype=np.uint32)
    r = cols % LANE
    if r:
        m[-1] = (0xFFFFFFFF << (LANE - r)) & 0xFFFFFFFF
    return m


# ---------------------------------------------------------------------------
# elementwise GF(2) ops (reference: binmat.cpp:463-496, binmat.h:164-170)
# ---------------------------------------------------------------------------

def xor(a, b):
    """GF(2) addition — the reference's ``add`` / ``bool_xor``."""
    return jnp.bitwise_xor(a, b)


add = xor  # reference naming (binmat.h:164)


def bool_and(a, b):
    return jnp.bitwise_and(a, b)


def bool_or(a, b):
    return jnp.bitwise_or(a, b)


def flip(packed, cols: int):
    """Complement all bits, keeping trailing padding zero (binmat.cpp:174-178)."""
    return jnp.bitwise_xor(packed, jnp.asarray(trail_mask(cols)))


# ---------------------------------------------------------------------------
# popcount reductions (reference: binmat.cpp:22-126)
# ---------------------------------------------------------------------------

def popcount(packed):
    return lax.population_count(jnp.asarray(packed, jnp.uint32))


def weight(packed) -> jnp.ndarray:
    """Total number of set bits (reference ``weight()``, binmat.cpp:57)."""
    return popcount(packed).astype(jnp.int32).sum(axis=(-1, -2))


def row_weight(packed) -> jnp.ndarray:
    """[..., rows] number of ones per row (binmat.cpp:66-76)."""
    return popcount(packed).astype(jnp.int32).sum(axis=-1)


def col_weight(packed, cols: int) -> jnp.ndarray:
    """[..., cols] ones per column.  (Fixes the binmat.cpp:87 undercount bug.)"""
    return unpack(packed, cols).astype(jnp.int32).sum(axis=-2)


def gf2_sum(packed) -> jnp.ndarray:
    """Parity of all bits (reference ``sum()``, binmat.cpp:95)."""
    return weight(packed) & 1


def row_sum(packed) -> jnp.ndarray:
    """Per-row parity (binmat.cpp:99-110)."""
    return row_weight(packed) & 1


def col_sum(packed) -> jnp.ndarray:
    """Per-column parity as a packed 1-row matrix (binmat.cpp:113-126)."""
    acc = jnp.asarray(packed, jnp.uint32)
    red = jax.lax.reduce(acc, jnp.uint32(0), jnp.bitwise_xor, (acc.ndim - 2,))
    return red[..., None, :]


def dist(a, b) -> jnp.ndarray:
    """Hamming distance = popcount(a ^ b) (reference dist, binmat.cpp:499-512).

    The workhorse of every codec driver's candidate search.
    """
    return weight(jnp.bitwise_xor(a, b))


# ---------------------------------------------------------------------------
# GF(2) matrix products as count matmuls (reference: binmat.cpp:516-616)
# ---------------------------------------------------------------------------

def _dense(packed, cols: int, dtype=jnp.float32):
    return unpack(packed, cols).astype(dtype)


def _parity_matmul(a_dense, b_dense):
    """(a @ b) mod 2 with the count as an f32 matmul.

    float32 accumulation is exact for inner dimensions < 2**24; assert is on
    the caller.  preferred_element_type pins accumulation to f32; with 0/1 operands
    the counts are exact in TF32 too while they stay below 2^24.
    """
    counts = jnp.dot(a_dense, b_dense, preferred_element_type=jnp.float32)
    return jnp.mod(counts, 2.0).astype(jnp.bool_)


def mul(a, a_cols: int, at: bool, b, b_cols: int, bt: bool) -> jnp.ndarray:
    """GF(2) product C = op(A) * op(B), returned packed.

    Dispatch mirrors reference mul (binmat.cpp:606-616); all four transpose
    combinations are implemented (mul_AtBt is an unimplemented stub in the
    reference, binmat.cpp:596-604).

    a: packed [ra, nwords(a_cols)]; b: packed [rb, nwords(b_cols)].
    """
    ad = _dense(a, a_cols)
    bd = _dense(b, b_cols)
    if at:
        ad = jnp.swapaxes(ad, -1, -2)
    if bt:
        bd = jnp.swapaxes(bd, -1, -2)
    assert ad.shape[-1] == bd.shape[-2], (
        f"GF(2) matmul dim mismatch {ad.shape} x {bd.shape}")
    return pack(_parity_matmul(ad, bd))


def and_counts(a, b, cols: int) -> jnp.ndarray:
    """Integer inner products <Ai, Bj> over AND: counts[i, j] = |Ai & Bj|.

    The matmul formulation of the reference's XOR/popcount 'binary matmul' shape
    (mul_ABt, binmat.cpp:575).  a: [n, w], b: [m, w] packed -> int32 [n, m].
    """
    ad = _dense(a, cols)
    bd = _dense(b, cols)
    return jnp.dot(ad, bd.T, preferred_element_type=jnp.float32).astype(jnp.int32)


def dist_matrix(a, b, cols: int) -> jnp.ndarray:
    """All-pairs Hamming distances d[i,j] = |Ai ^ Bj| via a matmul.

    d = |Ai| + |Bj| - 2 <Ai, Bj>.  This is the batched form of the reference's
    per-pair ``dist`` hot loop (e.g. compress8_test.cpp:152-198,
    bsvd.cpp:1065-1094) — one matmul instead of n*m scalar loops.
    """
    wa = row_weight(a)[..., :, None]
    wb = row_weight(b)[..., None, :]
    return wa + wb - 2 * and_counts(a, b, cols)


# ---------------------------------------------------------------------------
# structural ops
# ---------------------------------------------------------------------------

def transpose(packed, rows: int, cols: int) -> jnp.ndarray:
    """Packed transpose (fixes reference get_transposed non-square bug)."""
    return pack(jnp.swapaxes(unpack(packed, cols), -1, -2))


def submatrix(packed, i0: int, i1: int, j0: int, j1: int, cols: int):
    """Extract rows [i0,i1) x cols [j0,j1), repacked.

    Reference: get_submatrix / copy_submatrix_to (binmat.cpp:259-298).
    Static bounds; for traced offsets use lax.dynamic_slice on the unpacked
    plane (see search.py which never materializes per-candidate copies).
    """
    d = unpack(packed, cols)[..., i0:i1, j0:j1]
    return pack(d)


def set_submatrix(packed, sub, i0: int, j0: int, cols: int, sub_cols: int):
    """Write back a packed submatrix at (i0, j0) (binmat.cpp:373-414)."""
    d = unpack(packed, cols)
    s = unpack(sub, sub_cols)
    d = d.at[..., i0:i0 + s.shape[-2], j0:j0 + s.shape[-1]].set(s)
    return pack(d)


def patchify(img_bits, W: int) -> jnp.ndarray:
    """bool [rows, cols] -> bool [Ny*Nx, W, W] tile grid, raster order.

    rows/cols are padded up to multiples of W with zeros, matching the
    reference's ragged-tile handling (get_submatrix beyond the image reads
    zeros after the driver's ceil-div tiling, compress8_test.cpp:110-111).
    """
    rows, cols = img_bits.shape[-2:]
    ny, nx = -(-rows // W), -(-cols // W)
    pr, pc = ny * W - rows, nx * W - cols
    if pr or pc:
        img_bits = jnp.pad(img_bits,
                           [(0, 0)] * (img_bits.ndim - 2) + [(0, pr), (0, pc)])
    lead = img_bits.shape[:-2]
    t = img_bits.reshape(lead + (ny, W, nx, W))
    t = jnp.swapaxes(t, -3, -2)  # [..., ny, nx, W, W]
    return t.reshape(lead + (ny * nx, W, W))


def unpatchify(tiles, rows: int, cols: int, W: int) -> jnp.ndarray:
    """Inverse of patchify; crops padding back to (rows, cols)."""
    ny, nx = -(-rows // W), -(-cols // W)
    lead = tiles.shape[:-3]
    t = tiles.reshape(lead + (ny, nx, W, W))
    t = jnp.swapaxes(t, -3, -2).reshape(lead + (ny * W, nx * W))
    return t[..., :rows, :cols]


def vectorize_patches(tiles) -> jnp.ndarray:
    """[..., N, W, W] bool tiles -> packed rows [..., N, nwords(W*W)].

    Reference: copy_vectorized_to (binmat.cpp:300-341) — there a bit-shifted
    repacking loop (with a known read-past-end defect at binmat.cpp:331);
    here a pure reshape before packing.
    """
    N, W = tiles.shape[-3], tiles.shape[-1]
    return pack(tiles.reshape(tiles.shape[:-3] + (N, W * W)))


def unvectorize_patches(packed_rows, W: int) -> jnp.ndarray:
    """Packed [..., N, nwords(W*W)] -> bool tiles [..., N, W, W]."""
    bits = unpack(packed_rows, W * W)
    n = bits.shape[-2]
    return bits.reshape(bits.shape[:-2] + (n, W, W))


# ---------------------------------------------------------------------------
# numpy twin (host-side oracle & IO helper; identical layout)
# ---------------------------------------------------------------------------

def np_pack(bits: np.ndarray) -> np.ndarray:
    bits = np.asarray(bits, dtype=np.uint8)
    cols = bits.shape[-1]
    w = nwords(cols)
    pad = w * LANE - cols
    if pad:
        bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    by = np.packbits(bits, axis=-1)  # MSB-first bytes
    by = by.reshape(by.shape[:-1] + (w, 4)).astype(np.uint32)
    return (by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8) | by[..., 3]


def np_unpack(packed: np.ndarray, cols: int) -> np.ndarray:
    packed = np.asarray(packed, dtype=np.uint32)
    by = np.stack([(packed >> s) & 0xFF for s in (24, 16, 8, 0)], axis=-1)
    by = by.astype(np.uint8).reshape(packed.shape[:-1] + (packed.shape[-1] * 4,))
    bits = np.unpackbits(by, axis=-1)
    return bits[..., :cols].astype(bool)
