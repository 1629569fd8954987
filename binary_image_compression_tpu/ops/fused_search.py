"""Windowed patch search of the codec-4/7/8 encoders on the packed field plane.

Every tile compares its W x W patch with every candidate of its causal
search window and keeps the candidate the reference's serial scan would
keep (compress8_test.cpp:152-198: early exit at T in scan order, otherwise
strict-< argmin).  Candidates are W-bit row fields: E[y, x] holds the
pixels img[y, x:x+W] as one uint32, so a patch distance is nit XOR +
popcount steps over k row fields packed per word (_pair_plane).  Each
candidate folds into ONE int32 priority (packed_sel_layout) whose minimum
over the window IS the scan outcome, so a tile reduces to a single min and
no distance map ever leaves the chip.

The search is plain jnp left to XLA (_window_priorities, vmapped over tile
rows), on every platform.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_INF = 2 ** 30


def _key_span(W: int, R: int) -> int:
    """Scan-key row stride: > any per-row x extent (2R+W+1).

    Keys only ORDER candidates (y desc, x desc within each grid; grid 1
    before grid 2), so the stride needs to exceed the window's x range, not
    the image width — keeping keys small enough that the packed priority
    fits int32 for ANY image width."""
    return 2 * R + W + 2


def packed_sel_layout(W: int, R: int, cols: int):
    """Bit layout for the single-reduction packed selection, or None if the
    (key, distance, inv) triple cannot fit below the int32 INF sentinel.

    The serial-scan selection semantics (stop-first, then lexicographic
    (d', key) argmin) collapse into ONE min-reduction over

        p = stop ? key << (db+1) | d' << 1 | inv            (< FLAG)
                 : FLAG | d' << (kb+1) | key << 1 | inv

    because scan keys are unique per candidate (ord1 < off1 <= ord2 and each
    grid's order is injective), so the packed minimum IS the reference scan
    outcome and the winning candidate's coordinates decode from the key by
    scalar arithmetic (_packed_decode).

    Requires R >= W: the R+1-row band geometry every device search variant
    shares only covers grid-1 rows i0-W..i0 when R >= W (models/compress
    routes R < W to the host encoder)."""
    if R < W:
        return None
    M = W * W
    span = _key_span(W, R)
    off1 = (W + 2) * span
    # grid-2 row terms span (R - W) rows; +1 row of x slack
    keymax = off1 + (R - W + 1) * span
    kb = keymax.bit_length()
    db = M.bit_length()                 # d' <= M
    if db + kb + 3 > 30:                # FLAG | d' | key | inv < INF = 2^30
        return None
    return dict(span=span, off1=off1, kb=kb, db=db,
                flag=1 << (db + kb + 2))


def fused_supported(W: int, R: int, cols: int) -> bool:
    """Whether the field-plane search covers this shape: W <= 32 (one row
    field per uint32), R >= W (band geometry) and a packed layout that
    fits int32.  Other shapes take the banded XLA search."""
    return W <= 32 and packed_sel_layout(W, R, cols) is not None


def fields_per_word(W: int) -> int:
    """k W-bit row fields share one uint32 (rows a, a+nit, ..), so one
    XOR + popcount accumulates k row distances at once."""
    return next((k for k in (4, 3, 2) if W * k <= 32 and W % k == 0), 1)


def _priority(d, y, x, i0, j0, *, W, R, T_thresh, cols, invert, lay):
    """Packed (stop, d', key, inv) priority of candidates at absolute
    (y, x) with distance d, for the tile at absolute (i0, j0); INF off the
    window.  All arguments broadcast."""
    M = W * W
    span, off1 = lay["span"], lay["off1"]
    kb, db, flag = lay["kb"], lay["db"], lay["flag"]
    minj = jnp.maximum(j0 - R, 0)
    maxj2 = jnp.maximum(j0 - W, 0)
    maxj = jnp.minimum(j0 + R, cols - W)
    # no y bound below the image: grid-1 candidates of bottom-edge tiles
    # extend into the zero-padded rows, exactly as the host enumeration does
    in1 = ((y >= jnp.maximum(i0 - W, 0)) & (y <= i0)
           & (x >= minj) & (x <= maxj2) & (j0 >= W))
    in2 = ((y >= jnp.maximum(i0 - R, 0)) & (y <= i0 - W)
           & (x >= minj) & (x <= maxj))
    key1 = jnp.where(in1, (i0 - y) * span + (maxj2 - x), _INF)
    key2 = jnp.where(in2, off1 + (i0 - W - y) * span + (maxj - x), _INF)
    key = jnp.minimum(key1, key2)
    valid = in1 | in2
    if invert:
        dp = jnp.minimum(d, M - d)
        invb = ((M - d) < d).astype(jnp.int32)
    else:
        dp = d
        invb = jnp.zeros_like(d)
    keyv = jnp.where(valid, key, 0)     # keep shifts in range off-window
    p = jnp.where(dp <= T_thresh,
                  (keyv << (db + 1)) | (dp << 1) | invb,
                  flag | (dp << (kb + 1)) | (keyv << 1) | invb)
    return jnp.where(valid, p, _INF)


def _packed_decode(pr, i0, j0, oy, *, W, R, cols, lay):
    """Decode a packed-priority minimum into the 8 selection outputs
    (bestd, dy, inv, found, rank, n_cands, has_cands, dx).

    pr/i0/j0/oy are mutually broadcastable int32 in absolute coordinates;
    dy is relative to oy, dx is the absolute column."""
    span, off1 = lay["span"], lay["off1"]
    kb, db = lay["kb"], lay["db"]
    FLAG = jnp.int32(lay["flag"])
    maxx = cols - W
    minj = jnp.maximum(j0 - R, 0)
    maxj2 = jnp.maximum(j0 - W, 0)
    maxj = jnp.minimum(j0 + R, maxx)

    found = (pr < _INF).astype(jnp.int32)
    is_stop = pr < FLAG
    kmask = jnp.int32((1 << kb) - 1)
    dmask = jnp.int32((1 << db) - 1)
    key_sel = jnp.where(is_stop, pr >> (db + 1), (pr >> 1) & kmask)
    bestd = jnp.where(is_stop, (pr >> 1) & dmask, (pr >> (kb + 1)) & dmask)
    inv_s = pr & 1

    # decode the winning candidate's (y, x) from its scan key
    g2 = key_sel >= off1
    q = jnp.where(g2, key_sel - off1, key_sel)
    ry = lax.div(q, jnp.int32(span))                 # q >= 0
    xt = q - ry * span
    y = jnp.where(g2, i0 - W - ry, i0 - ry)
    x = jnp.where(g2, maxj - xt, maxj2 - xt)
    dy = jnp.where(found == 1, y - oy, 0)
    dx = jnp.where(found == 1, x, 0)
    inv_s = jnp.where(found == 1, inv_s, 0)
    bestd = jnp.where(found == 1, bestd, 0)

    # closed-form candidate counts: both window grids are rectangles in
    # (scan-row, scan-col) space, fully covered by the band (R >= W)
    r1 = jnp.minimum(W, i0) + 1
    c1 = jnp.where(j0 >= W, maxj2 - minj + 1, 0)
    r2 = jnp.maximum(i0 - W - jnp.maximum(i0 - R, 0) + 1, 0)
    c2 = maxj - minj + 1
    n_cands = r1 * c1 + r2 * c2

    def count_lt(ks, c, r):
        # |{(ry, xt): 0<=ry<r, 0<=xt<c, ry*span + xt < ks}| (c < span)
        nf = jnp.clip(jnp.where(ks >= c, lax.div(ks - c, jnp.int32(span))
                                + 1, 0), 0, r)
        rem = jnp.clip(ks - nf * span, 0, c)
        part = jnp.where(nf < r, rem, 0)
        return jnp.where((c > 0) & (ks > 0), nf * c + part, 0)

    rank = count_lt(key_sel, c1, r1) + \
        count_lt(jnp.where(g2, key_sel - off1, jnp.int32(-1)), c2, r2)
    rank = jnp.where(found == 1, rank, 0)
    has_cands = (n_cands > 0).astype(jnp.int32)
    return (bestd, dy, inv_s, found, rank, n_cands, has_cands, dx)


def _field_plane(img, W: int, He: int, We: int):
    """E[y, x] = the W-bit row field img[y, x:x+W] as a uint32 (bits W-1..0).

    Row-im2col in packed form: W shift-ors over the 0/1 image — the whole
    patch bank the search needs, at 1/Wth the footprint of a dense im2col."""
    imgp = jnp.zeros((He, We + W), jnp.uint32)
    imgp = lax.dynamic_update_slice(imgp, img.astype(jnp.uint32), (0, 0))
    E = jnp.zeros((He, We), jnp.uint32)
    for a in range(W):
        E = E | (imgp[:, a:a + We] << (W - 1 - a))
    return E


def _pair_plane(E, W: int, cols_out: int):
    """int32 plane of k row fields per word (rows a, a+nit, ..), zero
    columns appended up to cols_out.  Popcount is oblivious to the field
    boundaries (fields never interact under XOR), so sums are exact."""
    He, We = E.shape
    k = fields_per_word(W)
    nit = W // k
    P = E
    if k > 1:
        Ex = jnp.pad(E, ((0, W), (0, 0)))
        P = jnp.zeros((He, We), jnp.uint32)
        for m in range(k):
            P = P | (Ex[m * nit:m * nit + He] << (W * (k - 1 - m)))
    P = jnp.pad(P, ((0, 0), (0, max(0, cols_out - We))))
    return lax.bitcast_convert_type(P, jnp.int32)


def _window_priorities(P, trow, i0r, oyr, yb, *, W, R, T_thresh, cols,
                       invert, nx):
    """Packed-priority minimum per tile, int32 [ny, nx], vmapped over tile
    rows: per tile the [R+1, 2R+1] window of distances, their priorities
    and the minimum.  XLA fuses the XOR/popcount/priority chain into the
    min-reduction, so the window grid is never stored.

    P: int32 pair plane (_pair_plane, search_columns wide); trow: int32
    [ny, nx, nit] tile words; i0r/oyr: int32 [ny] frame rows of each tile
    row and its band; yb: int32 [1] absolute row of frame row 0."""
    lay = packed_sel_layout(W, R, cols)
    nit = trow.shape[2]
    wh, cw = R + 1, 2 * R + 1
    j0 = jnp.arange(nx, dtype=jnp.int32) * W
    xt = jnp.maximum(j0 - R, 0)
    x = (xt[:, None] + jnp.arange(cw, dtype=jnp.int32))[:, None, :]
    bh = wh + nit - 1

    def row(i0, oy, tw):
        band = lax.dynamic_slice(P, (oy, 0), (bh, P.shape[1]))
        win = jax.vmap(lambda c: lax.dynamic_slice(band, (0, c),
                                                   (bh, cw)))(xt)
        d = sum(lax.population_count(win[:, a:a + wh] ^
                                     tw[:, a, None, None])
                for a in range(nit))                       # [nx, wh, cw]
        y = (oy + yb[0] + jnp.arange(wh, dtype=jnp.int32))[None, :, None]
        p = _priority(d, y, x, i0 + yb[0], j0[:, None, None], W=W, R=R,
                      T_thresh=T_thresh, cols=cols, invert=invert, lay=lay)
        return p.min(axis=(1, 2))

    return jax.vmap(row)(i0r, oyr, trow)


def search_columns(nx: int, W: int, R: int, We: int) -> int:
    """Pair-plane width the search reads: every tile's 2R+1 window columns
    from max(j0 - R, 0) (a slice past the plane would silently clamp)."""
    return max(We, max((nx - 1) * W - R, 0) + 2 * R + 1)


def search_select(img_bits, i0, j0, ny: int, nx: int, *, W: int, R: int,
                  T_thresh: int, rows: int, cols: int, invert: bool,
                  y_base=None):
    """The codec windowed search + serial-scan selection for every tile.

    img_bits: 0/1 [ny*W, nx*W] padded tile grid (or a halo-extended frame
    of one).  i0/j0: int32 [T] FRAME-relative tile origins, raster order.
    y_base: optional traced scalar — the ABSOLUTE image row of frame row 0
    (parallel/tileshard); causal masks and ranks use absolute rows, bands
    and gathers stay frame-relative, so sharded streams equal the
    single-device enumeration.

    Returns (sel, oy [T], ox [T], E): sel holds bestd/dy/dx/bestinv/found/
    rank/n_cands/has_cands per tile (dy relative to oy, dx absolute with
    ox = 0); E is the single-field plane for the field-domain finish
    (models/compress._finish_selection_fields)."""
    assert fused_supported(W, R, cols), (W, R, cols)
    lay = packed_sel_layout(W, R, cols)
    img = jnp.asarray(img_bits, jnp.uint32)
    gh, gw = img.shape
    wh = R + 1
    Hp = gh - W + 1
    pad_h = max(0, wh - Hp)
    nit = W // fields_per_word(W)
    E = _field_plane(img, W, gh + pad_h, gw)
    P = _pair_plane(E, W, search_columns(nx, W, R, gw))
    yb = jnp.asarray([0 if y_base is None else y_base], jnp.int32)
    i0 = jnp.asarray(i0, jnp.int32)
    j0 = jnp.asarray(j0, jnp.int32)
    i0r = i0.reshape(ny, nx)[:, 0]
    oyr = jnp.clip(i0r - R, 0, max(Hp + pad_h - wh, 0))
    aoff = jnp.arange(nit, dtype=jnp.int32)
    trow = P[i0[:, None] + aoff[None, :], j0[:, None]].reshape(ny, nx, nit)
    pr = _window_priorities(P, trow, i0r, oyr, yb, W=W, R=R,
                            T_thresh=T_thresh, cols=cols, invert=invert,
                            nx=nx)

    T = ny * nx
    oy = jnp.repeat(oyr, nx)
    outs = _packed_decode(pr.reshape(T), i0 + yb[0], j0, oy + yb[0],
                          W=W, R=R, cols=cols, lay=lay)
    bestd, dy, inv, found, rank, n_cands, has_cands, dx = outs
    sel = dict(bestd=bestd, dy=dy, dx=dx, bestinv=inv.astype(jnp.bool_),
               found=found.astype(jnp.bool_), rank=rank, n_cands=n_cands,
               has_cands=has_cands.astype(jnp.bool_))
    return sel, oy, jnp.zeros((T,), jnp.int32), E
