"""Windowed self-referential patch matching as convolutions and matmuls.

The reference's codec hot loop (compress8_test.cpp:152-198 and friends) scans
candidate patches one at a time with get_submatrix + dist — O(tiles * R^2 *
W^2 / 64) scalar XOR/popcount.  The device formulation: Hamming distance to a
0/1 patch is an affine function of a cross-correlation,

    d(y, x) = |P| + boxsum(I)(y, x) - 2 * (I \\star P)(y, x),

so ALL candidate distances for ALL tiles are one grouped convolution
(per-tile kernels).  Selection then reproduces the
reference's serial scan semantics exactly — first-hit early exit at
threshold T, strict-< argmin tie-break in scan order — as a masked reduction
with a lexicographic (distance, scan-order) key.

Window geometry (compress4..8, compress4_test.cpp:96-135):
  grid 1 ("same rows, behind"): y in [max(i0-W,0), i0], x in [max(j0-R,0),
      max(j0-W,0)], scanned y desc, x desc;
  grid 2 ("rows above"):        y in [max(i0-R,0), i0-W], x in [max(j0-R,0),
      min(j0+R, cols-W)], scanned y desc, x desc; grid 1 precedes grid 2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# plain numpy scalar: a module-level jnp constant would initialize the XLA
# backend at import time, breaking jax.distributed.initialize ordering
_INF_KEY = np.int32(2**30)


def tile_origins(rows: int, cols: int, W: int):
    """Raster-order (i0, j0) for the ceil-div tile grid (compress8:110-111)."""
    ny, nx = -(-rows // W), -(-cols // W)
    ii, jj = jnp.meshgrid(jnp.arange(ny), jnp.arange(nx), indexing="ij")
    return (ii * W).ravel(), (jj * W).ravel(), ny, nx


def window_distance_maps(img_dense, i0, j0, W: int, R: int):
    """Distances from each tile to every candidate in its search window.

    img_dense: 0/1 [H, Wd] (any float/int dtype; cast to bf16 for the matmul).
    i0, j0: int32 [T] tile origins.  Returns (d, oy, ox) with
    d: int32 [T, R+1, 2R+W+1] distances, candidate (yy, xx) at absolute
    position (oy[t] + yy, ox[t] + xx); entries beyond the image are garbage
    and must be masked by the caller (select_* does).
    """
    H, Wd = img_dense.shape
    T = i0.shape[0]
    wh = R + W            # rows of extracted context
    ww = 2 * R + 2 * W    # cols of extracted context
    # clamped slice origins (XLA dynamic_slice clamps identically)
    oy = jnp.clip(i0 - R, 0, max(H - wh, 0))
    ox = jnp.clip(j0 - R, 0, max(Wd - ww, 0))
    imgp = jnp.pad(img_dense, ((0, max(0, wh - H)), (0, max(0, ww - Wd))))
    x = imgp.astype(jnp.bfloat16)

    def grab(oy_t, ox_t):
        return lax.dynamic_slice(x, (oy_t, ox_t), (wh, ww))

    ctx = jax.vmap(grab)(oy, ox)  # [T, wh, ww]

    tiles = jax.vmap(
        lambda a, b: lax.dynamic_slice(x, (a, b), (W, W)))(i0, j0)

    # grouped conv: each tile correlates only with its own context
    lhs = ctx[None]                        # [1, T, wh, ww]
    rhs = tiles[:, None]                   # [T, 1, W, W]
    corr = lax.conv_general_dilated(
        lhs, rhs, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=T,
        preferred_element_type=jnp.float32)[0]          # [T, wh-W+1, ww-W+1]

    ones = jnp.ones((1, 1, W, W), jnp.bfloat16)
    box = lax.conv_general_dilated(
        ctx[:, None], ones, (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32)[:, 0]       # same spatial shape

    pw = tiles.astype(jnp.float32).sum(axis=(1, 2))     # |P| per tile
    d = (pw[:, None, None] + box - 2.0 * corr).astype(jnp.int32)
    return d, oy, ox


def scan_keys(i0, j0, oy, ox, dshape, W: int, R: int, cols: int, rows: int,
              decodable: bool = False):
    """Scan-order keys for the two window grids.

    Returns (key1, key2): int32 [T, h, w], _INF_KEY outside the grid.  A
    candidate may be in both grids (the reference enumerates the y = i0-W
    row twice); selection uses min(key1, key2) and bitstream ranks count
    both entries (models/compress.py).  decodable=True restricts grid 1 to
    j0 >= W (codec.window_candidates geometry, DEVIATIONS.md 6)."""
    T, h, w = dshape
    yy = lax.broadcasted_iota(jnp.int32, (T, h, w), 1)
    xx = lax.broadcasted_iota(jnp.int32, (T, h, w), 2)
    y = oy[:, None, None] + yy
    x = ox[:, None, None] + xx
    i0b = i0[:, None, None]
    j0b = j0[:, None, None]
    maxx = cols - W

    mini2 = jnp.maximum(i0b - W, 0)
    minj = jnp.maximum(j0b - R, 0)
    maxj2 = jnp.maximum(j0b - W, 0)
    mini = jnp.maximum(i0b - R, 0)
    maxj = jnp.minimum(j0b + R, maxx)

    # NOTE: no y <= rows-W bound — the host enumeration (window_candidates,
    # native geom) lets grid-1 candidates extend into the zero-padded tile
    # rows exactly as the reference's get_submatrix does, and bottom-edge
    # tiles DO select them (a y-bound here silently shifted ranks on
    # ragged-height images; caught by the strict-mode fuzz in round 2).
    # x needs no bound either: grid 1 has x <= j0-W <= cols-W, grid 2
    # clamps maxj to cols-W already.
    in1 = (y >= mini2) & (y <= i0b) & (x >= minj) & (x <= maxj2)
    if decodable:
        in1 = in1 & (j0b >= W)
    in2 = (y >= mini) & (y <= i0b - W) & (x >= minj) & (x <= maxj)

    span = cols + 1
    ord1 = (i0b - y) * span + (maxj2 - x)
    off1 = (W + 2) * span  # every ord1 < off1
    ord2 = off1 + (i0b - W - y) * span + (maxj - x)
    key1 = jnp.where(in1, ord1, _INF_KEY)
    key2 = jnp.where(in2, ord2, _INF_KEY)
    return key1, key2


def _scan_keys(i0, j0, oy, ox, dshape, W, R, cols, rows):
    k1, k2 = scan_keys(i0, j0, oy, ox, dshape, W, R, cols, rows)
    return jnp.minimum(k1, k2)


def select_best(d, key, T_thresh: int, M: int, invert: bool,
                tile_weight=None):
    """Reproduce the reference's serial scan outcome from (d, key) arrays.

    Returns (bestd, besty_rel, bestx_rel_flat_idx, bestinv, found):
      * first candidate in scan order with d' <= T short-circuits
        (the perfect_match break, compress8_test.cpp:166-170);
      * otherwise argmin of d' with earliest-scan-order tie-break (strict <);
      * invert=True applies the compress8 complement trick d' = min(d, M-d)
        with inv = (M-d) < d (the reference leaves inv uninitialized on the
        else-path — compress8_test.cpp:157; DEVIATIONS.md item 3).
    d, key: int32 [T, h, w].  bestidx is the flat h*w window index.
    """
    Tn, h, w = d.shape
    valid = key < _INF_KEY
    if invert:
        dp = jnp.minimum(d, M - d)
        inv = (M - d) < d
    else:
        dp = d
        inv = jnp.zeros_like(d, dtype=bool)

    dpf = dp.reshape(Tn, -1)
    keyf = key.reshape(Tn, -1)
    validf = valid.reshape(Tn, -1)
    invf = inv.reshape(Tn, -1)

    stop = validf & (dpf <= T_thresh)
    any_stop = stop.any(axis=1)
    stop_key = jnp.where(stop, keyf, _INF_KEY)
    stop_idx = jnp.argmin(stop_key, axis=1)

    # two-stage lexicographic (d', scan-key) argmin — avoids int overflow
    big = jnp.int32(2**30)
    dmin = jnp.min(jnp.where(validf, dpf, big), axis=1, keepdims=True)
    at_min = validf & (dpf == dmin)
    min_idx = jnp.argmin(jnp.where(at_min, keyf, _INF_KEY), axis=1)

    bestidx = jnp.where(any_stop, stop_idx, min_idx)
    take = lambda a: jnp.take_along_axis(a, bestidx[:, None], axis=1)[:, 0]
    bestd = take(dpf)
    bestinv = take(invf)
    found = take(validf)
    return bestd, bestidx, bestinv, found


def window_distance_maps_banded(img_dense, i0, j0, W: int, R: int,
                                ny: int, nx: int):
    """Row-band matmul search: one [nx, W^2] x [W^2, band] matmul per tile-row.

    For the tiles of one grid row (fixed i0), every candidate lies in the
    row band [max(i0-R,0), i0] x [0, cols-W].  lax.scan over the ny tile
    rows keeps the graph small (one banded matmul compiled once), each step
    a genuine contraction over the W^2 patch dimension — unlike the
    grouped conv, which lowers to depthwise VPU work.  Output matches
    window_distance_maps' contract.
    """
    H, Wd = img_dense.shape
    Hp, Wp = H - W + 1, Wd - W + 1
    wh = R + 1
    ww = 2 * R + W + 1
    x = img_dense.astype(jnp.bfloat16)

    # im2col once: [W*W, Hp, Wp]
    patches = lax.conv_general_dilated_patches(
        x[None, None], (W, W), (1, 1), "VALID")[0]
    box = patches.astype(jnp.float32).sum(axis=0)            # [Hp, Wp]
    # pad the band dimension so every band slice fits
    pad_h = max(0, wh - Hp)
    pad_w = max(0, ww - Wp)
    patches = jnp.pad(patches, ((0, 0), (0, pad_h), (0, 0)))
    box = jnp.pad(box, ((0, pad_h), (0, pad_w)),
                  constant_values=jnp.float32(2**24))

    i0r = i0.reshape(ny, nx)
    j0r = j0.reshape(ny, nx)

    def row_step(_, row):
        i0_row, j0_row = row
        base = jnp.clip(i0_row[0] - R, 0, max(Hp + pad_h - wh, 0))
        band = lax.dynamic_slice(patches, (0, base, 0),
                                 (W * W, wh, Wp))             # [M, wh, Wp]
        bm = band.reshape(W * W, wh * Wp)
        tiles = jax.vmap(
            lambda a, b: lax.dynamic_slice(x, (a, b), (W, W)))(i0_row, j0_row)
        tm = tiles.reshape(nx, W * W)
        corr = jnp.dot(tm, bm,
                       preferred_element_type=jnp.float32)    # [nx, wh*Wp]
        pw = tm.astype(jnp.float32).sum(axis=1)
        bandbox = lax.dynamic_slice(box, (base, 0), (wh, Wp + pad_w))
        d_band = (pw[:, None, None]
                  + bandbox[None, :, :Wp]
                  - 2.0 * corr.reshape(nx, wh, Wp))
        d_band = jnp.pad(d_band, ((0, 0), (0, 0), (0, pad_w)),
                         constant_values=jnp.float32(2**24))
        ox_row = jnp.clip(j0_row - R, 0, max(Wp + pad_w - ww, 0))
        d_row = jax.vmap(lambda m, b: lax.dynamic_slice(
            m, (0, b), (wh, ww)))(d_band, ox_row)             # [nx, wh, ww]
        return None, (d_row.astype(jnp.int32), base, ox_row)

    _, (d, bases, oxs) = lax.scan(row_step, None, (i0r, j0r))
    T = ny * nx
    d = d.reshape(T, wh, ww)
    oy = jnp.repeat(bases, nx)
    ox = oxs.reshape(T)
    return d, oy, ox
