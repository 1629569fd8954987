"""Device codec path: jittable encoder analysis + bitstream I/O.

This is the throughput path for the BIC1 codec-8 family (models/codec.py is
the host-reference implementation; both emit byte-identical causal-mode
streams, asserted by tests/test_compress_tpu.py).

Causal-mode pipeline (all on device, one jit):
  1. windowed search + serial-scan selection on the packed field plane
     (ops/fused_search.search_select — the reference's dist() hot loop,
     compress8_test.cpp:152-198, as W-bit row-field XOR+popcounts reduced
     to one packed priority per tile; banded search for shapes it does
     not cover);
  2. candidate gather, inversion, MED prediction, per-mode weights;
  3. all four candidate residuals packed to uint32.

Host side fuses the mode decision (two adaptive Golomb contexts threaded
serially through the tiles) with the record packing in ONE native call
(bic_decide_pack); page batches overlap that host work with the device
analysis of later pages.  Strict mode (residual substitution) is the
native host encoder (models/codec.encode).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops import bitpack, predict, search
from ..ops.bitstream import BitWriter, enum_encode, enum_nbits, golomb_encode
from ..ops.entropy import GolombCoder
from .codec import CodecParams, _header, image_crc


def _check_W(params):
    """Same guard as codec.encode: the native runtime and the decoder
    reject W outside [1, 64], so the device encoders must too (a stream with
    W = 65 in its header would be unreadable by our own decoder)."""
    if not 1 <= params.W <= 64:
        raise ValueError(f"tile width W={params.W} out of range [1, 64]")


def _idx_len(n_cands):
    """Integer-exact ceil(log2(n)) = max(1, (n-1).bit_length()) for n > 0.

    The host encoder uses Python int bit_length; a float32 log2 could round
    k + eps at exact powers of two and widen the index field by one bit —
    which would silently desynchronize encoder and decoder."""
    n1 = (jnp.maximum(n_cands, 1) - 1).astype(jnp.int32)
    ks = jnp.int32(1) << jnp.arange(31, dtype=jnp.int32)
    bl = (n1[..., None] >= ks).sum(axis=-1).astype(jnp.int32)
    return jnp.where(n_cands > 0, jnp.maximum(1, bl), 0)


def _med_tiles(P):
    """Batched MED residual on dense tiles [T, W, W] (invertible origin)."""
    up = jnp.pad(P, ((0, 0), (1, 0), (0, 0)))[:, :-1, :]
    left = jnp.pad(P, ((0, 0), (0, 0), (1, 0)))[:, :, :-1]
    upleft = jnp.pad(P, ((0, 0), (1, 0), (1, 0)))[:, :-1, :-1]
    return P ^ up ^ left ^ upleft


@partial(jax.jit, static_argnames=("W", "R", "T_thresh", "rows", "cols",
                                   "invert", "variant"))
def encode_analyze(img_bits, *, W: int, R: int, T_thresh: int,
                   rows: int, cols: int, invert: bool = True,
                   variant: str = "fused"):
    """Device-side encoder analysis for codecs 4/7/8 (causal-original mode).
    invert=False disables the complement trick (codecs 4/7).

    img_bits: bool/int [ny*W, nx*W] (zero-padded tile grid).
    Returns per-tile arrays: rank, n_cands, inv, has_cands, idx_len,
    weights4 (the four candidate codings' residual weights) and residual4
    (the four candidate residuals, packed uint32).

    variant selects the search (all numerically identical,
    tests/test_compress_tpu.py, tests/test_pallas.py):
      * "fused" (default): ops/fused_search on the packed field plane.
        Shapes it does not cover (W > 32, a packed layout past int32) take
        "banded".
      * "banded": row-band contractions over the W^2 patch dimension via
        lax.scan (search.window_distance_maps_banded) + masked-reduction
        selection;
      * "conv": per-tile grouped convolution — the first formulation, kept
        for small-shape A/B comparison ONLY.  KNOWN BAD at scale on the CPU
        backend: XLA CPU miscompiles the feature_group_count=T grouped conv
        under jit for T ~ 1024 (streams stay decodable but ~30% bigger —
        caught by tests/test_compress_tpu.py::test_tpu_matches_host_doc512).
    """
    if R < W:
        # every device search variant shares the R+1-row band geometry,
        # which misses grid-1 candidate rows above i0-R when R < W — the
        # encode()/encode_batch() entry points route such params to the
        # host encoder
        raise ValueError(f"device search requires R >= W (got R={R}, "
                         f"W={W}); use models/codec.encode")
    if variant not in ("fused", "banded", "conv"):
        raise ValueError(f"unknown search variant {variant!r}")
    i0, j0, ny, nx = search.tile_origins(rows, cols, W)
    img = jnp.asarray(img_bits, jnp.int8)

    from ..ops import fused_search
    if variant == "fused" and fused_search.fused_supported(W, R, cols):
        sel, oy, ox, plane = fused_search.search_select(
            img, i0, j0, ny, nx, W=W, R=R, T_thresh=T_thresh, rows=rows,
            cols=cols, invert=invert)
        if 32 % W == 0 and W * W >= 32:
            # field-domain finish: patches gathered as [T, W] uint32 row
            # fields from the search's own plane (no dense re-pack)
            return _finish_selection_fields(plane, sel, (i0, j0, oy, ox),
                                            W=W, invert=invert)
        return _finish_selection(img, sel, (i0, j0, oy, ox), W=W,
                                 invert=invert)
    if variant == "conv":
        d, oy, ox = search.window_distance_maps(img, i0, j0, W, R)
    else:
        d, oy, ox = search.window_distance_maps_banded(img, i0, j0, W, R,
                                                       ny, nx)
    return _select_and_pack(img, d, (i0, j0, oy, ox), (i0, j0, oy, ox),
                            W=W, R=R, T_thresh=T_thresh, invert=invert,
                            rows=rows, cols=cols)


def _select_and_pack(frame, d, abs_coords, gather_coords, *,
                     W: int, R: int, T_thresh: int, invert: bool,
                     rows: int, cols: int):
    """Selection + per-mode residual stage over distance maps d, shared by
    the single-device and tile-sharded banded analyzers.

    abs_coords = (i0, j0, oy, ox) in IMAGE coordinates (drive the causal
    masks / scan-order ranks); gather_coords are FRAME-relative twins for
    patch gathers (identical on one device; halo-extended under shard_map).
    """
    Tn = d.shape[0]
    i0, j0, oy, ox = abs_coords
    key1, key2 = search.scan_keys(i0, j0, oy, ox, d.shape, W, R,
                                  cols, rows, decodable=True)
    key = jnp.minimum(key1, key2)
    bestd, bestidx, bestinv, found = search.select_best(
        d, key, T_thresh, W * W, invert=invert)
    # any valid candidate at all?
    validf = (key < search._INF_KEY).reshape(Tn, -1)
    has_cands = validf.any(axis=1)
    n_cands = (key1 < search._INF_KEY).reshape(Tn, -1).sum(axis=1) + \
              (key2 < search._INF_KEY).reshape(Tn, -1).sum(axis=1)
    # enumeration rank including the duplicate y=i0-W row entries
    key_sel = jnp.take_along_axis(key.reshape(Tn, -1), bestidx[:, None],
                                  axis=1)[:, 0]
    rank = ((key1.reshape(Tn, -1) < key_sel[:, None]).sum(axis=1)
            + (key2.reshape(Tn, -1) < key_sel[:, None]).sum(axis=1))
    w = d.shape[2]
    sel = dict(dy=bestidx // w, dx=bestidx % w, bestinv=bestinv,
               has_cands=has_cands, n_cands=n_cands, rank=rank)
    return _finish_selection(frame, sel, gather_coords, W=W, invert=invert)


def _finish_selection(frame, sel, gather_coords, *, W: int, invert: bool):
    """Gather the selected candidates, form the four mode residuals +
    weights, and pack — the tail every analyzer variant shares."""
    M = W * W
    i0g, j0g, oyg, oxg = gather_coords
    Tn = sel["rank"].shape[0]
    bestinv = sel["bestinv"]
    has_cands = sel["has_cands"]
    n_cands = sel["n_cands"]
    rank = sel["rank"]

    # candidate patches
    ysel = oyg + sel["dy"]
    xsel = oxg + sel["dx"]

    def grab(y, x):
        return lax.dynamic_slice(frame, (y, x), (W, W))

    P2 = jax.vmap(grab)(ysel, xsel)                      # [T, W, W]
    P = jax.vmap(grab)(i0g, j0g)
    Pm = jnp.where(bestinv[:, None, None], 1 - P, P)
    P3 = Pm ^ P2
    dP3 = _med_tiles(P3)
    dP = _med_tiles(P)

    w_mnp = P3.sum(axis=(1, 2), dtype=jnp.int32)
    w_mp = dP3.sum(axis=(1, 2), dtype=jnp.int32)
    w_nnp = P.sum(axis=(1, 2), dtype=jnp.int32)
    w_np_ = dP.sum(axis=(1, 2), dtype=jnp.int32)

    idx_len = _idx_len(n_cands)

    # The per-tile mode decision threads two adaptive Golomb contexts
    # sequentially through the tiles — 4 integer adds per tile, a serial
    # chain that is native host work (bic_decide_pack).  The device returns
    # per-mode weights and all four candidate residuals, packed.
    weights4 = jnp.stack([w_mnp, w_mp, w_nnp, w_np_], axis=1)  # [T, 4]
    res4 = jnp.stack([P3, dP3, P, dP], axis=1)                 # [T, 4, W, W]
    res_packed4 = bitpack.pack(res4.reshape(Tn, 4, M).astype(jnp.bool_))

    return dict(rank=rank, n_cands=n_cands, inv=bestinv,
                has_cands=has_cands, weights4=weights4,
                idx_len=idx_len, residual4=res_packed4)


def _finish_selection_fields(plane, sel, gather_coords, *, W: int,
                             invert: bool):
    """Field-domain twin of _finish_selection: the search's plane
    E[y, x] already holds every W-bit row field, so the selected candidate
    and tile patches are [T, W] uint32 gathers; inversion, MED, weights and
    the packed residuals are all field arithmetic.  Bit-identical outputs to
    _finish_selection (tests/test_pallas.py).  Requires 32 % W == 0 so W-bit
    fields concatenate exactly into the MSB-first packed uint32 layout, and
    W * W >= 32 so a residual fills whole words."""
    assert 32 % W == 0 and W * W >= 32
    M = W * W
    i0g, j0g, oyg, oxg = gather_coords
    Tn = sel["rank"].shape[0]
    ysel = oyg + sel["dy"]
    xsel = oxg + sel["dx"]
    ar = jnp.arange(W, dtype=jnp.int32)
    P2f = plane[ysel[:, None] + ar[None, :], xsel[:, None]]    # [T, W]
    Pf = plane[i0g[:, None] + ar[None, :], j0g[:, None]]
    wmask = jnp.uint32((1 << W) - 1)
    inv_ = sel["bestinv"]
    Pm = jnp.where(inv_[:, None], Pf ^ wmask, Pf)
    P3 = Pm ^ P2f

    def med(q):  # MED residual on row fields (bit W-1-c = column c)
        up = jnp.pad(q, ((0, 0), (1, 0)))[:, :-1]
        return (q ^ up ^ (q >> 1) ^ (up >> 1)) & wmask

    dP3 = med(P3)
    dPf = med(Pf)

    def wt(q):
        return lax.population_count(q).astype(jnp.int32).sum(axis=1)

    weights4 = jnp.stack([wt(P3), wt(dP3), wt(Pf), wt(dPf)], axis=1)
    res4f = jnp.stack([P3, dP3, Pf, dPf], axis=1)              # [T, 4, W]
    fpw = 32 // W                                  # fields per packed word
    r = res4f.reshape(Tn, 4, W // fpw, fpw).astype(jnp.uint32)
    shifts = (jnp.arange(fpw, dtype=jnp.uint32)[::-1] * W)
    res_packed4 = (r << shifts).sum(axis=-1, dtype=jnp.uint32)
    return dict(rank=sel["rank"], n_cands=sel["n_cands"], inv=inv_,
                has_cands=sel["has_cands"], weights4=weights4,
                idx_len=_idx_len(sel["n_cands"]), residual4=res_packed4)


@partial(jax.jit, static_argnames=("W", "R", "T_thresh", "rows", "cols",
                                   "invert", "variant"))
def encode_analyze_packed(img_packed, *, W: int, R: int, T_thresh: int,
                          rows: int, cols: int, invert: bool = True,
                          variant: str = "fused"):
    """encode_analyze of a bit-packed upload: img_packed is uint32
    [ny*W, nwords(nx*W)] (bitpack layout of the padded tile grid), 1/8th
    of the int8 grid's bytes."""
    nx = -(-cols // W)
    img = bitpack.unpack(img_packed, nx * W)
    return encode_analyze(img, W=W, R=R, T_thresh=T_thresh, rows=rows,
                          cols=cols, invert=invert, variant=variant)


def _packed_grid(img: np.ndarray, W: int) -> np.ndarray:
    """Bit-packed zero-padded tile grid(s) of bool [.., rows, cols]."""
    rows, cols = img.shape[-2:]
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros(img.shape[:-2] + (ny * W, nx * W), dtype=bool)
    grid[..., :rows, :cols] = img
    return bitpack.np_pack(grid)


def _decide_modes(out, M, codec_id=8):
    """Host replay of the mode decision with the two adaptive Golomb
    contexts (identical integer math to models/codec._encode_windowed).
    codec 8: 4 modes (+inv bit); codec 7: 4 modes; codec 4/6: 2 modes."""
    from ..ops.entropy import GolombCoder
    use_pred = codec_id in (7, 8)
    # actual record-header bits: match + (pred if use_pred) + (inv if codec 8)
    mcost = 1 + (1 if use_pred else 0) + (1 if codec_id == 8 else 0)
    ncost = 2 if use_pred else 1
    T = out["weights4"].shape[0]
    enb = np.array([enum_nbits(M, w) for w in range(M + 1)], dtype=np.int64)
    gm, gn = GolombCoder(), GolombCoder()
    mode = np.empty(T, dtype=np.int32)
    weight = np.empty(T, dtype=np.int32)
    k_used = np.empty(T, dtype=np.int32)
    w4 = np.asarray(out["weights4"])
    hc = np.asarray(out["has_cands"])
    il = np.asarray(out["idx_len"])
    gk = lambda g, u: g.k + (int(u) >> g.k) + 1
    big = 1 << 28
    for t in range(T):
        c = [
            mcost + il[t] + gk(gm, w4[t, 0]) + enb[w4[t, 0]]
            if hc[t] else big,
            mcost + il[t] + gk(gm, w4[t, 1]) + enb[w4[t, 1]]
            if (hc[t] and use_pred) else big,
            ncost + gk(gn, w4[t, 2]) + enb[w4[t, 2]],
            ncost + gk(gn, w4[t, 3]) + enb[w4[t, 3]] if use_pred else big,
        ]
        m = int(np.argmin(c))
        mode[t] = m
        weight[t] = w4[t, m]
        g = gm if m < 2 else gn
        k_used[t] = g.k
        g.code_sample(int(w4[t, m]))
    return mode, weight, k_used


def encode(img: np.ndarray, params: CodecParams | None = None,
           profile=None) -> bytes:
    """Device-path encode (causal mode, codecs 4/7/8): device analysis +
    native decision and bit assembly.  Byte-identical to
    models/codec.encode(strict=False).

    profile: optional utils.profiling.PipelineProfile collecting per-stage
    wall clock + bandwidth (`bic compress --profile`)."""
    from ..utils.profiling import PipelineProfile
    prof = profile if profile is not None else PipelineProfile()
    params = params or CodecParams(codec=8, strict=False)
    assert params.codec in (4, 7, 8) and not params.strict, \
        "device path implements codecs 4/7/8 in causal mode"
    _check_W(params)
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    W, R = params.W, params.R
    if R < W:   # device band geometry requires R >= W (encode_analyze)
        from .codec import encode as host_encode
        return host_encode(img, params)
    ny, nx = -(-rows // W), -(-cols // W)
    with prof.stage("grid_prep", rows * cols // 8):
        gdev = jnp.asarray(_packed_grid(img, W))
    with prof.stage("device_analysis"):
        out = jax.device_get(encode_analyze_packed(
            gdev, W=W, R=R, T_thresh=params.resolved_T(), rows=rows,
            cols=cols, invert=params.codec == 8))
    with prof.stage("native_pack"):
        hdr = _header(params, rows, cols, image_crc(img))
        blob = _assemble(out, hdr, W * W, ny * nx, params.codec)
    return blob


def _assemble(out, hdr, M, T, codec_id=8):
    # fast path: fused native mode-decision + pack (one call per page)
    from .. import native
    blob = native.decide_pack(hdr, M, codec_id, out["weights4"],
                              out["has_cands"], out["idx_len"], out["inv"],
                              out["rank"], out["residual4"])
    if blob is not None:
        return blob
    return _assemble_python(out, hdr, M, T, codec_id)


def _assemble_python(out, hdr, M, T, codec_id=8):
    """Pure-Python twin of native bic_decide_pack (no toolchain): replay
    the decision, pack records."""
    mode, weight, k_used = _decide_modes(out, M, codec_id)
    res_bits4 = bitpack.np_unpack(out["residual4"], M)     # [T, 4, M]
    res_bits = res_bits4[np.arange(T), mode]
    use_pred = codec_id in (7, 8)

    wtr = BitWriter()
    wtr.write_bits(int.from_bytes(hdr, "big"), len(hdr) * 8)
    for t in range(T):
        m = int(mode[t])
        if m < 2:  # match
            wtr.write_bits(1, 1)
            if use_pred:
                wtr.write_bits(m & 1, 1)
            if codec_id == 8:
                wtr.write_bits(int(out["inv"][t]), 1)
            wtr.write_bits(int(out["rank"][t]), int(out["idx_len"][t]))
        else:
            wtr.write_bits(0, 1)
            if use_pred:
                wtr.write_bits(m & 1, 1)
        golomb_encode(wtr, int(weight[t]), int(k_used[t]))
        enum_encode(wtr, res_bits[t])
    return wtr.getvalue()


def encode_batch(pages: np.ndarray, params: CodecParams | None = None,
                 *, vmapped: bool = False) -> list[bytes]:
    """Batched multi-page encode: device analysis for every page, then the
    native decision + pack per page on host threads, overlapping the device
    analysis of later pages.

    vmapped=False (default) dispatches the single-page jit once per page
    (the program encode() compiles too); vmapped=True runs one vmapped
    program over the batch.  pages: bool [B, rows, cols], same size."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    params = params or CodecParams(codec=8, strict=False)
    assert params.codec == 8 and not params.strict
    _check_W(params)
    pages = np.asarray(pages, dtype=bool)
    if params.R < params.W:   # device band geometry requires R >= W
        from .codec import encode as host_encode
        return [host_encode(p, params) for p in pages]
    B, rows, cols = pages.shape
    W = params.W
    ny, nx = -(-rows // W), -(-cols // W)
    packed = _packed_grid(pages, W)                          # [B, gh, nw]
    analyze = partial(encode_analyze_packed, W=W, R=params.R,
                      T_thresh=params.resolved_T(), rows=rows, cols=cols)
    if vmapped:
        outs = jax.device_get(jax.vmap(analyze)(jnp.asarray(packed)))
        fetched = ({k: v[b] for k, v in outs.items()} for b in range(B))
    else:
        # dispatch every page, start all device->host copies, then pack
        # each page as its copy lands
        handles = [analyze(jnp.asarray(packed[b])) for b in range(B)]
        for h in handles:
            for v in h.values():
                v.copy_to_host_async()
        fetched = (jax.device_get(h) for h in handles)

    def build(b, out):
        hdr = _header(params, rows, cols, image_crc(pages[b]))
        return _assemble(out, hdr, W * W, ny * nx)

    with ThreadPoolExecutor(max_workers=min(B, os.cpu_count() or 1)) as ex:
        futs = [ex.submit(build, b, out) for b, out in enumerate(fetched)]
        return [f.result() for f in futs]


# ---------------------------------------------------------------------------
# codec 13 device stage: per-pixel context ids for the whole page in one jit
# ---------------------------------------------------------------------------

def _shift2d(x, dr: int, dc: int):
    """out[r, c] = x[r+dr, c+dc], zeros outside the image (static offsets)."""
    rows, cols = x.shape
    xp = jnp.pad(x, ((max(0, -dr), max(0, dr)), (max(0, -dc), max(0, dc))))
    return lax.dynamic_slice(xp, (max(0, dr), max(0, dc)), (rows, cols))


# (dr, dc, bit) per template — MUST match the native incremental scan
# (native/bic_native.cpp scan_stripe) and codec._scab_ctx bit layouts
_SCAB_TMPL = {
    10: [(-2, -1, 9), (-2, 0, 8), (-2, 1, 7), (-1, -2, 6), (-1, -1, 5),
         (-1, 0, 4), (-1, 1, 3), (-1, 2, 2), (0, -2, 1), (0, -1, 0)],
    12: [(-2, -1, 11), (-2, 0, 10), (-2, 1, 9), (-1, -2, 8), (-1, -1, 7),
         (-1, 0, 6), (-1, 1, 5), (-1, 2, 4), (-1, 3, 3), (0, -3, 2),
         (0, -2, 1), (0, -1, 0)],
}


@partial(jax.jit, static_argnames=("tmpl", "stripe_rows"))
def scab_ctx_map(img_bits, *, tmpl: int, stripe_rows: int):
    """Codec-13 context ids of every pixel, on device (uint16 [rows, cols]).

    The whole causal-template stage of the codec-12/13 family as shifted
    packed planes — embarrassingly parallel, so it lives on the device;
    the serial range-coder update stays on host.
    Template reads above each STRIPE top return 0 (stripes are independent
    streams, decodable in parallel)."""
    img = jnp.asarray(img_bits, jnp.uint16)
    rows = img.shape[0]
    rr = jnp.arange(rows, dtype=jnp.int32) % stripe_rows
    ctx = jnp.zeros_like(img)
    for dr, dc, bit in _SCAB_TMPL[tmpl]:
        plane = _shift2d(img, dr, dc)
        if dr < 0:  # rows whose r+dr falls above the stripe top read 0
            plane = plane * (rr >= -dr).astype(jnp.uint16)[:, None]
        ctx = ctx | (plane << bit)
    return ctx


def encode_scab(img: np.ndarray, params: CodecParams | None = None, *,
                entropy: str = "host") -> bytes:
    """Device-path codec-13 encode.

    entropy="host" (default): the per-pixel context template runs on device
    for the whole page in one jit (scab_ctx_map); the host does only the
    serial adaptive range-coder update per pixel, stripes across threads.
    Byte-identical to codec.encode(codec=13) (tests/test_codec.py).

    entropy="device": the ENTIRE payload assembles on device (payload mode
    2) — context map, per-context counts, quantized static probability
    table, and N interleaved rANS lanes per stripe coded by one lax.scan
    with the word streams packed by the parallel-prefix pack_varlen
    (ops/ransdevice).  A different (documented) payload
    format from the host coder: static semi-adaptive model instead of
    per-bit adaptation, ~5-10% larger streams, but the serial chain drops
    from stripe_pixels to stripe_pixels / n_lanes and the coder itself
    runs on device.  Decoded by the same codec.decode entry point (native
    bic_scab_rans_decode or the Python twin)."""
    from .codec import CodecParams as CP
    from .codec import _encode_scab, scab_defaults
    params = params or CP(codec=13, W=0, T=0, R=0)
    assert params.codec == 13
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    tmpl, n_stripes = scab_defaults(params, rows)
    stripe_rows = -(-rows // n_stripes)
    if entropy == "device":
        return _encode_scab_device(img, params, tmpl, n_stripes,
                                   stripe_rows)
    ctx = np.asarray(jax.device_get(scab_ctx_map(
        jnp.asarray(img, jnp.uint8), tmpl=tmpl, stripe_rows=stripe_rows)))
    return _encode_scab(img, params, ctx_pre=ctx)


@partial(jax.jit, static_argnames=("tmpl", "n_stripes", "stripe_rows",
                                   "n_lanes"))
def scab_rans_page(img_u8, *, tmpl: int, n_stripes: int, stripe_rows: int,
                   n_lanes: int):
    """Context map + full mode-2 rANS payload assembly as ONE jit."""
    from ..ops import ransdevice
    ctx = scab_ctx_map(img_u8, tmpl=tmpl, stripe_rows=stripe_rows)
    return ransdevice.rans_page_encode(img_u8, ctx, n_stripes=n_stripes,
                                       stripe_rows=stripe_rows,
                                       n_lanes=n_lanes)


def _encode_scab_device(img, params, tmpl, n_stripes, stripe_rows,
                        n_lanes: int | None = None) -> bytes:
    """Serialize the device-assembled mode-2 payload (host does byte
    concatenation only).  Body layout (after the BIC1 header):

      u8 tmpl | u8 mode=2 | u16 n_stripes | i32 stripe_rows     (as mode 0/1)
      u8 n_lanes | u8 q_default | u16 n_transmit
      u8 bitmap_mode (0 raw / 1 Rice gaps) | u8 rice_k | u16 bitmap_bytes
      bitmap section: raw 512 B mask, or Rice(k) codes of the gaps
        between transmitted context ids (g0 = id0, gi = id_i - id_{i-1} - 1)
      ceil(n_transmit * 6 / 8) B probability codes (MSB-first)
      u32 stripe_byte_len[n_stripes]
      per stripe: n_lanes x u32 LE initial decoder states,
                  then the u16 big-endian rANS word stream
    """
    from ..ops import ransdevice
    rows, cols = img.shape
    n_lanes = n_lanes or ransdevice.N_LANES_DEFAULT
    out = scab_rans_page(jnp.asarray(img, jnp.uint8), tmpl=tmpl,
                         n_stripes=n_stripes, stripe_rows=stripe_rows,
                         n_lanes=n_lanes)
    fetched = dict(zip(
        ("transmit", "q_default", "states", "bits", "tab_words",
         "tab_bits", "n_transmit"),
        jax.device_get((out["transmit"], out["q_default"], out["states"],
                        out["bits"], out["tab_words"], out["tab_bits"],
                        out["n_transmit"]))))
    # ONE sliced fetch for all stripes: trim the [S, Wmax] word bank to the
    # longest live stream, then split on host
    nw_max = max(1, max(-(-int(b) // 32) for b in fetched["bits"]))
    fetched["words"] = np.asarray(jax.device_get(out["words"][:, :nw_max]))
    body = _serialize_scab_rans(fetched, tmpl, n_stripes, stripe_rows,
                                n_lanes)
    hdr = _header(params, rows, cols, image_crc(img))
    return hdr + body


def _serialize_scab_rans(f, tmpl, n_stripes, stripe_rows,
                         n_lanes) -> bytes:
    """Mode-2 body serialization from fetched numpy fields (host does byte
    concatenation only; shared by the single-page and the batched plane
    paths)."""
    import struct
    from ..ops.bitstream import BitWriter, golomb_encode, words_to_bytes
    # bitmap serialization: raw 512 B vs Rice-coded id gaps, pick smaller
    ids = np.flatnonzero(np.asarray(f["transmit"], bool))
    gaps = np.diff(np.concatenate([[-1], ids])) - 1
    best_k, best_bits = 0, None
    for k in range(13):
        nb = int(sum(k + (int(g) >> k) + 1 for g in gaps))
        if best_bits is None or nb < best_bits:
            best_k, best_bits = k, nb
    rice_bytes = -(-(best_bits or 0) // 8)
    if ids.size and rice_bytes < 512:
        bm_mode, rice_k = 1, best_k
        bw = BitWriter()
        for g in gaps:
            golomb_encode(bw, int(g), rice_k)
        bm_bytes = bw.getvalue()
    else:
        bm_mode, rice_k = 0, 0
        bm_bytes = np.packbits(np.asarray(f["transmit"], bool)).tobytes()
    body = bytearray()
    body += struct.pack("<BBHi", tmpl, 2, n_stripes, stripe_rows)
    body += struct.pack("<BBH", n_lanes, int(f["q_default"]),
                        int(f["n_transmit"]))
    body += struct.pack("<BBH", bm_mode, rice_k, len(bm_bytes))
    body += bm_bytes
    body += words_to_bytes(f["tab_words"], int(f["tab_bits"]))
    stream_bytes = []
    for s in range(n_stripes):
        stream_bytes.append(
            np.asarray(f["states"][s], "<u4").tobytes()
            + words_to_bytes(f["words"][s], int(f["bits"][s])))
    for sb in stream_bytes:
        body += struct.pack("<I", len(sb))
    for sb in stream_bytes:
        body += sb
    return bytes(body)


@partial(jax.jit, static_argnames=("tmpl", "n_stripes", "stripe_rows",
                                   "n_lanes"))
def _scab_rans_stack(stack, *, tmpl, n_stripes, stripe_rows, n_lanes):
    # module-level jit: a closure-local jit would retrace on EVERY call
    return jax.vmap(lambda g: scab_rans_page(
        g, tmpl=tmpl, n_stripes=n_stripes, stripe_rows=stripe_rows,
        n_lanes=n_lanes))(stack)


def encode_planes_rans(planes: np.ndarray,
                       params: CodecParams | None = None) -> list[bytes]:
    """Codec-13 mode-2 streams for a whole bitplane stack: ONE vmapped jit
    encodes every plane's payload on device (the grayscale analog of
    encode_planes_device, riding the round-5 rANS coder); the host
    serializes headers and stripe streams.  Used by
    codec.encode_pgm(backend="tpu-rans")."""
    from ..ops import ransdevice
    from .codec import CodecParams as CP
    from .codec import scab_defaults
    planes = np.asarray(planes, dtype=bool)
    P, rows, cols = planes.shape
    params = params or CP(codec=13, W=0, T=0, R=0)
    tmpl, n_stripes = scab_defaults(params, rows)
    stripe_rows = -(-rows // n_stripes)
    n_lanes = ransdevice.N_LANES_DEFAULT
    out = _scab_rans_stack(jnp.asarray(planes, jnp.uint8), tmpl=tmpl,
                           n_stripes=n_stripes, stripe_rows=stripe_rows,
                           n_lanes=n_lanes)
    keys = ("transmit", "q_default", "states", "bits", "tab_words",
            "tab_bits", "n_transmit")
    stacked = dict(zip(keys, jax.device_get(tuple(out[k] for k in keys))))
    nw_max = max(1, int(max(-(-int(b) // 32)
                            for b in stacked["bits"].ravel())))
    words = np.asarray(jax.device_get(out["words"][:, :, :nw_max]))
    blobs = []
    for i in range(P):
        f = {k: stacked[k][i] for k in keys}
        f["words"] = words[i]
        body = _serialize_scab_rans(f, tmpl, n_stripes, stripe_rows,
                                    n_lanes)
        hdr = _header(params, rows, cols, image_crc(planes[i]))
        blobs.append(hdr + body)
    return blobs


# ---------------------------------------------------------------------------
# device bitplane pipeline (BASELINE config #2; bitplane_tool.cpp:24-39)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cols",))
def med_planes(planes_bits, cols: int):
    """Batched MED residuals of all bitplanes on device.

    planes_bits: [P, rows, cols] 0/1.  Packs to uint32 lanes and runs the
    3-shift-XOR forward predictor (ops/predict.med_forward) across the whole
    plane stack in one compiled program — the device stage of the grayscale
    path (the rest, adaptive-EG run coding, is inherently sequential per run
    and runs in native C++).  Returns packed residuals [P, rows, nw]."""
    packed = bitpack.pack(jnp.asarray(planes_bits, jnp.bool_))
    return predict.med_forward(packed, cols)


def _eg_run_cap(n_pixels: int, level: int = 0) -> int:
    """Static run-array capacity ladder of the device-EG payload path.

    level 0: a 12.5%-ones density bound (n/8 + 2); level 1: 25% (n/4 + 2).
    ONE definition for both the in-jit slice (_planes_payload_device) and
    the host-side routing (encode_planes_device) — a desync would silently
    truncate payloads (ADVICE r3 item 2)."""
    return n_pixels // (8 >> level) + 2


@partial(jax.jit, static_argnames=("rows", "cols", "cap_level"))
def _planes_payload_device(planes_bits, *, rows: int, cols: int,
                           cap_level: int = 0):
    """Full codec-10 payload assembly for a plane stack, ON DEVICE:
    MED residual -> zero-run extraction -> adaptive-EG codes (the 32-state
    LUT adaptation as an associative scan over transition-table composition)
    -> parallel-prefix bit packing (ops/bitstream.pack_varlen).  The
    BASELINE-named parallel bitstream assembly, producing product bytes.

    Returns (words, total_bits, n_runs).  The run array is CAPPED at the
    cap_level density bound (_eg_run_cap): the associative scan and the
    [N, 32] transition sweep scale with the static run capacity, and the
    uncapped worst case (a run per pixel) made the whole pipeline ~8x
    slower than it needs to be for any MED residual that is actually
    compressible.  Callers must route planes with n_runs > cap to a higher
    level or the native coder (encode_planes_device does both)."""
    from ..ops import egdevice
    n = rows * cols
    cap = _eg_run_cap(n, cap_level)
    packed = bitpack.pack(jnp.asarray(planes_bits, jnp.bool_))
    res = predict.med_forward(packed, cols)                 # [P, rows, nw]
    res_bits = bitpack.unpack(res, cols).reshape(-1, n)     # [P, n]

    def one(flat):
        # cap bounds the nonzero gather AND everything downstream (the
        # transition sweep, the scan, the chunk math)
        runs, n_runs = egdevice.runs_from_residual_flat(flat, n_pixels=n,
                                                        cap=cap)
        w, tb = egdevice.eg_encode_runs_device(runs, n_runs, n_pixels=n)
        return w, tb, n_runs

    return jax.vmap(one)(res_bits)


@partial(jax.jit, static_argnames=("cols",))
def _planes_run_counts(planes_bits, cols: int):
    """Exact codec-10 run count per plane from the packed MED residual —
    the cheap routing pre-pass for the capacity ladder.  n_runs =
    n_ones + [trailing zero run exists], and the trailing run exists iff
    the residual is empty or its last pixel is 0."""
    packed = bitpack.pack(jnp.asarray(planes_bits, jnp.bool_))
    res = predict.med_forward(packed, cols)                 # [P, rows, nw]
    ones = jax.vmap(
        lambda r: jax.lax.population_count(r).sum(dtype=jnp.int32))(res)
    last_col = (cols - 1) % 32
    last_bit = (res[:, -1, -1] >> jnp.uint32(31 - last_col)) & jnp.uint32(1)
    trailing = (ones == 0) | (last_bit == 0)
    return ones + trailing.astype(jnp.int32)


def encode_planes_device(planes: np.ndarray,
                         assembly: str = "device") -> list[bytes]:
    """Codec-10 streams for a stack of bitplanes, byte-identical to
    codec.encode(plane, CodecParams(codec=10)) per plane (tests).

    assembly="device" (default): the ENTIRE encode runs as one jit — MED,
    run extraction, adaptive-EG and the parallel-prefix bit packing all on
    device; the host only prepends headers (needs no native lib at all).
    Planes are routed by a run-count pre-pass onto a static capacity
    ladder (12.5% / 25% ones density); denser residuals — which EG mostly
    expands anyway — go to the native coder, so one pathological plane no
    longer demotes the whole stack.
    assembly="native": device MED + native C++ EG runs (the r2 path)."""
    from ..ops.bitstream import words_to_bytes
    from . import codec as codec_mod
    planes = np.asarray(planes, dtype=bool)
    P, rows, cols = planes.shape
    n = rows * cols
    if assembly == "device":
        counts = np.asarray(jax.device_get(_planes_run_counts(
            jnp.asarray(planes, jnp.uint8), cols)))
        levels = {}
        native_idx = []
        for i in range(P):
            for lv in (0, 1):
                if counts[i] <= _eg_run_cap(n, lv):
                    levels.setdefault(lv, []).append(i)
                    break
            else:
                native_idx.append(i)
        params = codec_mod.CodecParams(codec=10, W=0, T=0, R=0)
        out: list[bytes | None] = [None] * P
        for lv, idxs in sorted(levels.items()):
            words, total_bits, n_runs = jax.device_get(
                _planes_payload_device(
                    jnp.asarray(planes[idxs], jnp.uint8), rows=rows,
                    cols=cols, cap_level=lv))
            for j, i in enumerate(idxs):
                tb = int(total_bits[j])
                if (tb > words.shape[1] * 32
                        or int(n_runs[j]) > _eg_run_cap(n, lv)):
                    # payload bound exceeded (should not happen: the
                    # pre-pass count is exact) — native for this plane
                    native_idx.append(i)
                    continue
                hdr = codec_mod._header(params, rows, cols,
                                        codec_mod.image_crc(planes[i]))
                out[i] = hdr + words_to_bytes(words[j], tb)
        if native_idx:
            nat = _encode_planes_native(planes[sorted(native_idx)], cols)
            for j, i in enumerate(sorted(native_idx)):
                out[i] = nat[j]
        return out
    return _encode_planes_native(planes, cols)


def _encode_planes_native(planes: np.ndarray, cols: int) -> list[bytes]:
    """Device MED + native C++ EG runs (the r2 path)."""
    from . import codec as codec_mod
    res_packed = jax.device_get(med_planes(jnp.asarray(planes, jnp.uint8),
                                           cols))
    res_bits = bitpack.np_unpack(res_packed, cols)          # [P, rows, cols]
    return [codec_mod._encode_medrle(planes[i],
                                     residual=res_bits[i].astype(np.uint8))
            for i in range(planes.shape[0])]


@partial(jax.jit, static_argnames=("W", "R", "T_thresh", "rows", "cols"))
def encode_analyze_strict(img_bits, *, W: int, R: int, T_thresh: int,
                          rows: int, cols: int):
    """Strict-mode (residual-substitution) encoder analysis on device.

    The reference's compress4..8 semantics: later tiles search the working
    image where earlier tiles were replaced by their residuals
    (compress8_test.cpp:294-300) — an inherently sequential chain, expressed
    as one lax.scan over tiles whose carry is the working image; per step a
    single-kernel conv computes the tile's whole candidate window.  Emits
    the same per-tile record set as encode_analyze; byte-identical streams
    to models/codec.encode(strict=True).

    NOT on any product path: it compiles pathologically (minutes at 512^2)
    and the native host encoder is the strict-mode encoder — kept only for
    explicit A/B comparison of the formulation."""
    M = W * W
    i0v, j0v, ny, nx = search.tile_origins(rows, cols, W)
    Tn = int(i0v.shape[0])
    gh, gw = ny * W, nx * W
    wh = R + W
    ww = 2 * R + 2 * W
    work0 = jnp.asarray(img_bits, jnp.bfloat16)
    # pad so context slices fit
    ph, pw_ = max(0, wh - gh), max(0, ww - gw)
    work0 = jnp.pad(work0, ((0, ph), (0, pw_)))

    enb = jnp.asarray([enum_nbits(M, ww_) for ww_ in range(M + 1)],
                      dtype=jnp.int32)
    ks = jnp.arange(32, dtype=jnp.uint32)
    ones_k = jnp.ones((1, 1, W, W), jnp.bfloat16)

    def gstep(acc, n, k, u):
        n = n + 1
        acc = acc + u.astype(jnp.uint32)
        ok = (n << ks) >= acc
        newk = jnp.where(jnp.any(ok), jnp.argmax(ok).astype(jnp.uint32),
                         jnp.uint32(31))
        return acc, n, newk

    def gcost(k, u):
        return k.astype(jnp.int32) + (u >> k.astype(jnp.int32)) + 1

    def step(carry, xs):
        work, (am, nm, km), (an, nn, kn) = carry
        i0, j0 = xs
        oy = jnp.clip(i0 - R, 0, max(gh + ph - wh, 0))
        ox = jnp.clip(j0 - R, 0, max(gw + pw_ - ww, 0))
        ctx = lax.dynamic_slice(work, (oy, ox), (wh, ww))
        P = lax.dynamic_slice(work, (i0, j0), (W, W))
        corr = lax.conv_general_dilated(
            ctx[None, None], P[None, None], (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            preferred_element_type=jnp.float32)[0, 0]
        box = lax.conv_general_dilated(
            ctx[None, None], ones_k, (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            preferred_element_type=jnp.float32)[0, 0]
        pw2 = P.astype(jnp.float32).sum()
        d = (pw2 + box - 2.0 * corr).astype(jnp.int32)[None]   # [1, h, w]
        key1, key2 = search.scan_keys(
            i0[None], j0[None], oy[None], ox[None], d.shape, W, R,
            cols, rows, decodable=True)
        key = jnp.minimum(key1, key2)
        bestd, bestidx, bestinv, _ = search.select_best(
            d, key, T_thresh, M, invert=True)
        bestd, bestidx, bestinv = bestd[0], bestidx[0], bestinv[0]
        validf = (key < search._INF_KEY).reshape(-1)
        has_cands = validf.any()
        n_cands = (key1 < search._INF_KEY).sum() + \
                  (key2 < search._INF_KEY).sum()
        key_sel = key.reshape(-1)[bestidx]
        rank = (key1.reshape(-1) < key_sel).sum() + \
               (key2.reshape(-1) < key_sel).sum()
        wmap = d.shape[2]
        ysel = oy + bestidx // wmap
        xsel = ox + bestidx % wmap
        P2 = lax.dynamic_slice(work, (ysel, xsel), (W, W))
        Pi = P.astype(jnp.int8)
        Pm = jnp.where(bestinv, 1 - Pi, Pi)
        P3 = Pm ^ P2.astype(jnp.int8)
        dP3 = _med_tiles(P3[None])[0]
        dP = _med_tiles(Pi[None])[0]
        w_mnp = P3.sum(dtype=jnp.int32)
        w_mp = dP3.sum(dtype=jnp.int32)
        w_nnp = Pi.sum(dtype=jnp.int32)
        w_np_ = dP.sum(dtype=jnp.int32)
        il = _idx_len(n_cands)
        big = jnp.int32(1 << 28)
        c0 = jnp.where(has_cands, 3 + il + gcost(km, w_mnp) + enb[w_mnp], big)
        c1 = jnp.where(has_cands, 3 + il + gcost(km, w_mp) + enb[w_mp], big)
        c2 = 2 + gcost(kn, w_nnp) + enb[w_nnp]
        c3 = 2 + gcost(kn, w_np_) + enb[w_np_]
        mode = jnp.argmin(jnp.stack([c0, c1, c2, c3])).astype(jnp.int32)
        is_match = mode < 2
        wt = jnp.stack([w_mnp, w_mp, w_nnp, w_np_])[mode]
        k_used = jnp.where(is_match, km, kn).astype(jnp.int32)
        am2, nm2, km2 = gstep(am, nm, km, wt)
        an2, nn2, kn2 = gstep(an, nn, kn, wt)
        ctx_m = (jnp.where(is_match, am2, am), jnp.where(is_match, nm2, nm),
                 jnp.where(is_match, km2, km))
        ctx_n = (jnp.where(is_match, an, an2), jnp.where(is_match, nn, nn2),
                 jnp.where(is_match, kn, kn2))
        res = jnp.stack([P3, dP3, Pi, dP])[mode]
        work = lax.dynamic_update_slice(work, res.astype(jnp.bfloat16),
                                        (i0, j0))
        res_packed = bitpack.pack(res.reshape(M).astype(jnp.bool_))
        out = dict(mode=mode, rank=rank, n_cands=n_cands, inv=bestinv,
                   weight=wt, k_used=k_used, idx_len=il,
                   residual=res_packed)
        return (work, ctx_m, ctx_n), out

    ctx0 = ((jnp.uint32(0), jnp.uint32(0), jnp.uint32(1)),
            (jnp.uint32(0), jnp.uint32(0), jnp.uint32(1)))
    (_, _, _), outs = lax.scan(step, (work0, *ctx0), (i0v, j0v))
    return outs
