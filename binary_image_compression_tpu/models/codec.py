"""Real, decodable bitstream codecs (the reference only ever *estimated*).

Container format ``BIC1``:

    magic   4B  "BIC1"
    crc32   u32 of the raw packed image bytes (integrity check on decode)
    codec   u8  (1 = full-prior-area tile codec (bounded decodable
                 compress1), 2/3 = dictionary codecs, 4/6/7/8 = windowed
                 tile codecs,
                 10 = full-image MED + adaptive run-length, 11 = learned
                 BSVD dictionary patch codec, 12 = context-adaptive binary
                 arithmetic coding)
    flags   u8  bit0: strict mode (candidates reference the
                residual-substituted working image, as compress4..8 do via
                in-place set_submatrix); else causal-original mode
                (candidates reference decoded original pixels — fully
                parallelizable search, see models/compress.py)
    W       u16 tile width (0 for codec 10)
    rows    u32
    cols    u32
    T       u32 early-exit threshold
    R       u32 search radius
    payload     bit-packed tile records / run-length stream

Tile record (codec 8; 7 = same without inv bit; 4/6 = no pred/inv bits):

    match   1 bit
    pred    1 bit
    [match] inv 1 bit (codec 8), index ceil(log2(n_candidates)) bits
    weight  adaptive Golomb-Rice, two contexts (match / nomatch) with the
            reference's k-adaptation (GolombCoder.cpp:29-33)
    residual enumerative rank, ceil(log2 C(M, weight)) bits (integer-bit
            realization of the reference's enumL cost, compress8:247-251)

Decodability requires two deviations from the reference estimator
(DEVIATIONS.md 3, 6): inv applies only on the match path, and grid-1
candidates exist only for j0 >= W (the reference's clamped maxj2=0 candidate
overlaps not-yet-coded pixels).  Window geometry is otherwise the
compress4..8 geometry, so compression performance tracks the reference's
estimates (tests assert the real size is within ~1% + small constant of the
reference's own codelength arithmetic on the same decisions).
"""

from __future__ import annotations

import math
import struct
import zlib
from dataclasses import dataclass

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from ..ops.entropy import GolombCoder
from ..ops.bitstream import (BitReader, BitWriter, enum_decode, enum_encode,
                             enum_nbits, golomb_decode, golomb_encode)

MAGIC = b"BIC1"


# ---------------------------------------------------------------------------
# shared geometry: candidate enumeration in scan order (decoder-reproducible)
# ---------------------------------------------------------------------------

def window_candidates(i0: int, j0: int, W: int, R: int,
                      rows: int, cols: int) -> list[tuple[int, int]]:
    """Scan-ordered causal candidates for tile (i0, j0).

    compress7/8 geometry (compress8_test.cpp:137-143) restricted to
    fully-coded pixels: grid 1 (same rows behind) requires j0 >= W; grid 2 is
    the rows strictly above.  Rows are bounded so candidate patches stay
    inside the padded tile grid the decoder maintains.
    """
    out = []
    mini = max(i0 - R, 0)
    minj = max(j0 - R, 0)
    maxj = min(j0 + R, cols - W)
    mini2 = max(i0 - W, 0)
    if j0 >= W:
        maxj2 = j0 - W
        for y in range(i0, mini2 - 1, -1):
            for x in range(maxj2, minj - 1, -1):
                out.append((y, x))
    yhi = i0 - W
    if yhi >= mini:
        for y in range(yhi, mini - 1, -1):
            for x in range(maxj, minj - 1, -1):
                out.append((y, x))
    return out


def c1_candidate_count(i0: int, j0: int, W: int, cols: int) -> int:
    """Candidate count for the decodable codec-1 geometry.

    compress_test.cpp:81-111 made decodable (DEVIATIONS.md 5): the
    reference's phase-A column scan runs j2 < cols, over-reading 64-bit
    block padding and the NEXT raster row — positions a decoder cannot
    reproduce (for candidates ending on row i0-1 the straddle reads the
    row band being decoded).  The decodable variant bounds columns to the
    fully in-bounds range [0, cols-W].  Enumeration is the reference's
    ascending raster scan: phase A = all rows strictly above the tile band
    × all in-bounds columns; phase B = rows (i0-W, i0] × columns
    [0, j0-W] (empty for j0 < W, as in the reference)."""
    wa = max(cols - W + 1, 0)
    na = max(i0 - W + 1, 0)
    wb = (j0 - W + 1) if j0 >= W else 0
    nb = i0 - max(i0 - W + 1, 0) + 1      # rows [max(i0-W+1, 0), i0]
    return na * wa + nb * wb


def _c1_rank_to_pos(rank: int, i0: int, j0: int, W: int,
                    cols: int) -> tuple[int, int]:
    """Inverse of the codec-1 ascending enumeration (closed form — the
    decoder never materializes candidate lists)."""
    wa = max(cols - W + 1, 0)
    na = max(i0 - W + 1, 0)
    if rank < na * wa:
        return rank // wa, rank % wa
    r2 = rank - na * wa
    wb = j0 - W + 1
    y0 = max(i0 - W + 1, 0)
    return y0 + r2 // wb, r2 % wb


def _c1_tables(orig: np.ndarray, W: int):
    """Per-image tables for the codec-1 full-prior-area search: windowed
    pixel sums S (integral image) so distances decompose as
    d = wP + S - 2·corr, with corr a BLAS matvec over a row-chunked
    im2col (the full im2col at W=64 would be ~4 GB)."""
    # int64 accumulation: float32 cumsum loses integer exactness past 2^24
    # cumulative set pixels, which large dense pages can reach
    g = orig.astype(np.int64)
    ii = np.zeros((g.shape[0] + 1, g.shape[1] + 1), np.int64)
    np.cumsum(np.cumsum(g, axis=0), axis=1, out=ii[1:, 1:])
    S = (ii[W:, W:] - ii[:-W, W:] - ii[W:, :-W]
         + ii[:-W, :-W]).astype(np.int32)
    return orig, S


def _c1_corr(orig: np.ndarray, Pv: np.ndarray, y0: int, y1: int,
             x1: int, W: int) -> np.ndarray:
    """corr[y, x] = <window(y, x), P> for y in [y0, y1), x in [0, x1),
    computed in row chunks of ~64 MB im2col float32."""
    out = np.empty((y1 - y0, x1), np.int32)
    step = max(1, (64 << 20) // max(1, x1 * W * W * 4))
    for ys in range(y0, y1, step):
        ye = min(ys + step, y1)
        sw = sliding_window_view(orig[ys:ye + W - 1], (W, W))[:, :x1]
        blk = np.ascontiguousarray(sw, dtype=np.float32)
        out[ys - y0:ye - y0] = (
            blk.reshape(ye - ys, x1, W * W) @ Pv).astype(np.int32)
    return out


def _search_c1(orig, S, P, i0, j0, W, cols, M):
    """First-strict-min over the codec-1 enumeration with the reference's
    d == 0 early exit (compress_test.cpp ascending scan; same running-min
    realization as _search_fast).  Returns (rank, bestd) or (None, M+1)."""
    Pv = P.astype(np.float32).ravel()
    wP = int(P.sum())
    wa = max(cols - W + 1, 0)
    na = max(i0 - W + 1, 0)
    parts = []
    if na > 0 and wa > 0:
        C = _c1_corr(orig, Pv, 0, na, wa, W)
        parts.append((wP + S[:na, :wa] - 2 * C).ravel())
    if j0 >= W:
        y0 = max(i0 - W + 1, 0)
        C = _c1_corr(orig, Pv, y0, i0 + 1, j0 - W + 1, W)
        parts.append((wP + S[y0:i0 + 1, :j0 - W + 1] - 2 * C).ravel())
    if not parts:
        return None, M + 1
    dp = np.concatenate(parts)
    stop = np.flatnonzero(np.minimum.accumulate(dp) <= 0)
    r = int(stop[0]) if stop.size else int(np.argmin(dp))
    return r, int(dp[r])


def _med(P):
    r = np.zeros_like(P)
    r[0, 1:] = P[0, 1:] ^ P[0, :-1]
    r[1:, 0] = P[1:, 0] ^ P[:-1, 0]
    r[1:, 1:] = P[1:, 1:] ^ P[:-1, 1:] ^ P[1:, :-1] ^ P[:-1, :-1]
    r[0, 0] = P[0, 0]  # invertible origin (DEVIATIONS.md 1)
    return r


def _unmed(r):
    x = np.bitwise_xor.accumulate(r, axis=1)
    return np.bitwise_xor.accumulate(x, axis=0)


@dataclass
class CodecParams:
    codec: int = 8
    W: int = 16
    T: int | None = None
    R: int = 128
    strict: bool = True

    def resolved_T(self) -> int:
        if self.T is not None:
            return self.T
        if self.codec == 8:  # compress8's auto threshold (compress8:72-74)
            M = self.W * self.W
            return int(math.ceil(math.log2((2 * self.R + 1) * self.R))
                       // math.ceil(math.log2(M)))
        if self.codec == 3:  # compress3's default (compress3_test.cpp:55)
            return self.W * self.W // 8
        return 0


def _search(work, P, cands, M, T, invert):
    """First-hit-at-threshold / strict-argmin scan (reference semantics with
    defined inv).  Returns (rank, bestd, inv) or (None, None, False)."""
    best = None
    bestd = M + 1
    bestinv = False
    for rank, (y, x) in enumerate(cands):
        P2 = work[y:y + P.shape[0], x:x + P.shape[1]]
        d = int((P ^ P2).sum(dtype=np.int32))
        inv = False
        if invert and (M - d) < d:
            inv = True
            d = M - d
        if d < bestd:
            best, bestd, bestinv = rank, d, inv
            if bestd <= T:
                break
    return best, bestd, bestinv


def _search_fast(work, P, cands, M, T, invert, W):
    """Vectorized equivalent of _search (same selection semantics)."""
    if not cands:
        return None, M + 1, False
    ca = np.asarray(cands, dtype=np.int32)
    sw = sliding_window_view(work, (W, W))
    d = (sw[ca[:, 0], ca[:, 1]] ^ P[None]).sum(axis=(-1, -2), dtype=np.int32)
    if invert:
        inv = (M - d) < d
        dp = np.minimum(d, M - d)
    else:
        inv = np.zeros(len(cands), dtype=bool)
        dp = d
    # serial semantics: the scan stops at the first index s where the running
    # strict minimum drops to <= T; that index is itself the chosen candidate
    # (an earlier equal value would have tripped the threshold earlier).
    # Without a threshold hit, the first strict minimum wins.
    runmin = np.minimum.accumulate(dp)
    stop_idx = np.flatnonzero(runmin <= T)
    r = int(stop_idx[0]) if stop_idx.size else int(np.argmin(dp))
    return r, int(dp[r]), bool(inv[r])


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

VALID_CODECS = (1, 2, 3, 4, 6, 7, 8, 10, 11, 12, 13)


def encode(img: np.ndarray, params: CodecParams | None = None,
           **kwargs) -> bytes:
    params = params or CodecParams()
    if params.codec not in VALID_CODECS:
        raise ValueError(f"unknown codec id {params.codec}; "
                         f"valid: {VALID_CODECS}")
    if params.codec in (1, 2, 3, 4, 6, 7, 8, 11) and not 1 <= params.W <= 64:
        # the native packed-row search holds one tile row per uint64
        # (native/bic_native.cpp PackedGrid::get_bits); W > 64 would smash
        # its stack and W = 0 divides by zero — reject at the API boundary
        raise ValueError(f"tile width W={params.W} out of range [1, 64] "
                         f"for codec {params.codec}")
    img = np.asarray(img, dtype=bool)
    if params.codec == 10:
        return _encode_medrle(img)
    if params.codec == 11:
        return _encode_bsvd(img, params, **kwargs)
    if params.codec == 12:
        return _encode_cabic(img, params)
    if params.codec == 13:
        return _encode_scab(img, params, **kwargs)
    if params.codec in (2, 3):
        return _encode_dict(img, params)
    if params.codec == 1:
        # compress1 searches the ORIGINAL image (compress_test.cpp uses I,
        # never substitutes residuals) — there is no strict variant
        import dataclasses
        params = dataclasses.replace(params, strict=False)
    return _encode_windowed(img, params)


HEADER_LEN = 28


def image_crc(img: np.ndarray) -> int:
    return zlib.crc32(np.packbits(np.asarray(img, dtype=bool)).tobytes())


def _header(params, rows, cols, crc: int = 0) -> bytes:
    flags = 1 if params.strict else 0
    return MAGIC + struct.pack("<IBBHIIII", crc, params.codec, flags,
                               params.W, rows, cols, params.resolved_T(),
                               params.R)


def _encode_windowed(img, params, use_native: bool = True) -> bytes:
    W, R = params.W, params.R
    T = params.resolved_T()
    codec = params.codec
    if codec == 1:
        use_native = False      # the native encoder knows only 4/6/7/8
    if use_native:
        from .. import native
        hdr = _header(params, *img.shape, image_crc(img))
        blob = native.encode_windowed(np.asarray(img, np.uint8), hdr,
                                      codec, params.strict, W, T, R)
        if blob is not None:
            return blob
    invert = codec == 8
    use_pred = codec in (7, 8)
    rows, cols = img.shape
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    work = np.zeros((ny * W, nx * W), dtype=np.uint8)
    work[:rows, :cols] = img
    orig = work.copy()
    ref_img = work if params.strict else orig
    if codec == 1:
        c1_orig, c1_S = _c1_tables(orig, W)

    w = BitWriter()
    hdr = _header(params, rows, cols, image_crc(img))
    w.write_bits(int.from_bytes(hdr, "big"), len(hdr) * 8)
    gm, gn = GolombCoder(), GolombCoder()

    for ti in range(ny):
        for tj in range(nx):
            i0, j0 = ti * W, tj * W
            P = (work if params.strict else orig)[i0:i0 + W, j0:j0 + W].copy()
            if codec == 1:
                rank, bestd = _search_c1(c1_orig, c1_S, P, i0, j0, W, cols, M)
                inv = False
                n_cands = c1_candidate_count(i0, j0, W, cols)
            else:
                cands = window_candidates(i0, j0, W, R, rows, cols)
                rank, bestd, inv = _search_fast(ref_img, P, cands, M, T,
                                                invert, W)
                n_cands = len(cands)
            idx_len = max(1, (n_cands - 1).bit_length()) if n_cands else 0

            # candidate residuals/costs for the 4 modes
            options = []
            if rank is not None:
                y, x = (_c1_rank_to_pos(rank, i0, j0, W, cols)
                        if codec == 1 else cands[rank])
                P2 = ref_img[y:y + W, x:x + W]
                Pm = (1 - P) if inv else P
                P3 = Pm ^ P2
                wm_np = int(P3.sum())
                # match-record header bits actually written below:
                # match + (pred if use_pred) + (inv if invert)
                cost = 1 + (1 if use_pred else 0) + (1 if invert else 0)
                options.append(("m", False, P3, wm_np,
                                cost + idx_len + _gcost(gm, wm_np)
                                + enum_nbits(M, wm_np)))
                if use_pred:
                    dP3 = _med(P3.astype(bool)).astype(np.uint8)
                    wm_p = int(dP3.sum())
                    options.append(("m", True, dP3, wm_p,
                                    cost + idx_len + _gcost(gm, wm_p)
                                    + enum_nbits(M, wm_p)))
            wn_np = int(P.sum())
            ncost = 2 if use_pred else 1
            options.append(("n", False, P, wn_np,
                            ncost + _gcost(gn, wn_np) + enum_nbits(M, wn_np)))
            if use_pred:
                dP = _med(P.astype(bool)).astype(np.uint8)
                wn_p = int(dP.sum())
                options.append(("n", True, dP, wn_p,
                                ncost + _gcost(gn, wn_p) + enum_nbits(M, wn_p)))
            kind, pred, res, wt, _ = min(options, key=lambda o: o[4])

            if kind == "m":
                w.write_bits(1, 1)
                if use_pred:
                    w.write_bits(int(pred), 1)
                if invert:
                    w.write_bits(int(inv), 1)
                w.write_bits(rank, idx_len)
                golomb_encode(w, wt, gm.k)
                gm.code_sample(wt)
            else:
                w.write_bits(0, 1)
                if use_pred:
                    w.write_bits(int(pred), 1)
                golomb_encode(w, wt, gn.k)
                gn.code_sample(wt)
            enum_encode(w, res.astype(bool))

            if params.strict:
                work[i0:i0 + W, j0:j0 + W] = res
    return w.getvalue()


def _gcost(g: GolombCoder, u: int) -> int:
    return g.k + (u >> g.k) + 1


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode(blob: bytes, *, use_native: bool = True,
           verify_crc: bool = True) -> np.ndarray:
    if blob[:4] != MAGIC:
        raise ValueError("not a BIC1 stream")
    crc, codec, flags, W, rows, cols, T, R = struct.unpack(
        "<IBBHIIII", blob[4:HEADER_LEN])
    # header fields come from an untrusted stream: validate BEFORE any
    # decoder (native or Python) divides by W or sizes buffers from it
    if codec not in VALID_CODECS:
        raise ValueError(f"corrupt BIC1 header: unknown codec id {codec}")
    if rows == 0 or cols == 0 or rows * cols > 2 ** 31:
        # the Python fallback decoders allocate O(rows*cols) byte buffers;
        # a corrupt header must not be an allocation bomb
        raise ValueError(f"implausible dimensions {rows}x{cols}")
    if codec in (1, 2, 3, 4, 6, 7, 8, 11) and not 1 <= W <= 64:
        # W=0 divides by zero in _decode_windowed and a huge W sizes
        # multi-GB work buffers from an untrusted header — same bound the
        # encode side enforces
        raise ValueError(f"corrupt BIC1 header: W={W} out of range [1, 64] "
                         f"for codec {codec}")
    out = None
    if codec in (4, 6, 7, 8) and use_native:
        from .. import native
        out = native.decode_windowed(blob, rows, cols)
    if out is None:
        r = BitReader(blob, bit_offset=HEADER_LEN * 8)
        if codec == 13:
            out = _decode_scab(blob[HEADER_LEN:], rows, cols)
        elif codec == 12:
            out = _decode_cabic(blob[HEADER_LEN:], rows, cols)
        elif codec == 10:
            out = _decode_medrle_payload(blob[HEADER_LEN:], rows, cols)
        elif codec == 11:
            out = _decode_bsvd(r, W, rows, cols)
        elif codec in (2, 3):
            out = _decode_dict(r, codec, W, rows, cols, T)
        else:
            out = _decode_windowed(r, codec, W, rows, cols, T, R,
                                   strict=bool(flags & 1))
    if verify_crc and image_crc(out) != crc:
        raise ValueError("BIC1 integrity check failed (corrupt stream)")
    return out


def _decode_windowed(r, codec, W, rows, cols, T, R, strict):
    invert = codec == 8
    use_pred = codec in (7, 8)
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    work = np.zeros((ny * W, nx * W), dtype=np.uint8)   # encoder's state
    out = np.zeros((ny * W, nx * W), dtype=np.uint8)    # original pixels
    ref_img = work if strict else out
    gm, gn = GolombCoder(), GolombCoder()
    for ti in range(ny):
        for tj in range(nx):
            i0, j0 = ti * W, tj * W
            match = r.read_bits(1)
            pred = r.read_bits(1) if use_pred else 0
            if match:
                inv = r.read_bits(1) if invert else 0
                if codec == 1:
                    n_cands = c1_candidate_count(i0, j0, W, cols)
                else:
                    cands = window_candidates(i0, j0, W, R, rows, cols)
                    n_cands = len(cands)
                idx_len = max(1, (n_cands - 1).bit_length()) if n_cands else 0
                rank = r.read_bits(idx_len)
                if rank >= n_cands:
                    # corrupt stream: the rank would index past the candidate
                    # enumeration (for codec 1 this would otherwise reach the
                    # phase-B arithmetic with wb <= 0 -> ZeroDivisionError)
                    raise ValueError("corrupt stream: candidate rank "
                                     f"{rank} >= {n_cands}")
                wt = golomb_decode(r, gm.k)
                gm.code_sample(wt)
            else:
                inv = 0
                wt = golomb_decode(r, gn.k)
                gn.code_sample(wt)
            res = enum_decode(r, M, wt).reshape(W, W).astype(np.uint8)
            # reconstruct P
            if match:
                y, x = (_c1_rank_to_pos(rank, i0, j0, W, cols)
                        if codec == 1 else cands[rank])
                P2 = ref_img[y:y + W, x:x + W]
                P3 = _unmed(res.astype(bool)).astype(np.uint8) if pred else res
                Pm = P3 ^ P2
                P = (1 - Pm) if inv else Pm
            else:
                P = _unmed(res.astype(bool)).astype(np.uint8) if pred else res
            out[i0:i0 + W, j0:j0 + W] = P
            if strict:
                work[i0:i0 + W, j0:j0 + W] = res
    return out[:rows, :cols].astype(bool)


# ---------------------------------------------------------------------------
# dictionary codecs (compress2/3 capability, made decodable)
# ---------------------------------------------------------------------------

def _encode_dict(img, params) -> bytes:
    """compress2/3-style: dictionary of previously-coded tile *origins*.

    The reference stores tile loop indices and reads patches at those pixel
    coords (compress2_test.cpp:108) — an evident bug; the decodable codec
    stores tile origins.  Dict evolution is recomputed by the decoder, so
    only (match?, index, weight, residual) is coded.
    """
    W = params.W
    T = params.resolved_T()
    add_rule_threshold = params.codec == 3
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    grid = np.zeros((ny * W, nx * W), dtype=np.uint8)
    grid[:rows, :cols] = img
    w = BitWriter()
    hdr = _header(params, rows, cols, image_crc(img))
    w.write_bits(int.from_bytes(hdr, "big"), len(hdr) * 8)
    gm, gn = GolombCoder(), GolombCoder()
    dictionary: list[tuple[int, int]] = []
    # vectorized search: tiles as flat rows, dictionary as a growing row
    # bank; one [|dict|]-wide XOR-popcount per tile replaces the per-entry
    # Python loop (serial scan semantics preserved: first strict minimum)
    tiles_flat = grid.reshape(ny, W, nx, W).swapaxes(1, 2).reshape(
        ny * nx, M).astype(np.uint8)
    dict_rows = np.zeros((ny * nx, M), dtype=np.uint8)
    li = 0
    for ti in range(ny):
        for tj in range(nx):
            i0, j0 = ti * W, tj * W
            P = grid[i0:i0 + W, j0:j0 + W]
            Pf = tiles_flat[li]
            nd = len(dictionary)
            if nd:
                ds = (dict_rows[:nd] ^ Pf[None, :]).sum(axis=1,
                                                        dtype=np.int32)
                bestk = int(np.argmin(ds))
                bestd = int(ds[bestk])
            else:
                bestk, bestd = 0, M + 1
            wP = int(P.sum())
            idx_len = max(1, (len(dictionary) - 1).bit_length()) \
                if dictionary else 0
            use_match = False
            if dictionary:
                mcost = 1 + idx_len + _gcost(gm, bestd) + enum_nbits(M, bestd)
                ncost = 1 + _gcost(gn, wP) + enum_nbits(M, wP)
                use_match = mcost < ncost
            if use_match:
                w.write_bits(1, 1)
                w.write_bits(bestk, idx_len)
                golomb_encode(w, bestd, gm.k)
                gm.code_sample(bestd)
                ci, cj = dictionary[bestk]
                enum_encode(w, (P ^ grid[ci:ci + W, cj:cj + W]).astype(bool))
            else:
                w.write_bits(0, 1)
                golomb_encode(w, wP, gn.k)
                gn.code_sample(wP)
                enum_encode(w, P.astype(bool))
            # dictionary update rule (decoder replays it identically)
            if (add_rule_threshold and bestd > T) or \
                    (not add_rule_threshold and not use_match):
                dict_rows[len(dictionary)] = Pf
                dictionary.append((i0, j0))
            li += 1
    return w.getvalue()


def _decode_dict(r, codec, W, rows, cols, T):
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    grid = np.zeros((ny * W, nx * W), dtype=np.uint8)
    gm, gn = GolombCoder(), GolombCoder()
    dictionary: list[tuple[int, int]] = []
    dict_rows = np.zeros((ny * nx, M), dtype=np.uint8)
    add_rule_threshold = codec == 3
    for ti in range(ny):
        for tj in range(nx):
            i0, j0 = ti * W, tj * W
            match = r.read_bits(1)
            idx_len = max(1, (len(dictionary) - 1).bit_length()) \
                if dictionary else 0
            if match:
                k = r.read_bits(idx_len)
                wt = golomb_decode(r, gm.k)
                gm.code_sample(wt)
                res = enum_decode(r, M, wt).reshape(W, W).astype(np.uint8)
                ci, cj = dictionary[k]
                P = res ^ grid[ci:ci + W, cj:cj + W]
            else:
                wt = golomb_decode(r, gn.k)
                gn.code_sample(wt)
                P = enum_decode(r, M, wt).reshape(W, W).astype(np.uint8)
            grid[i0:i0 + W, j0:j0 + W] = P
            # replay dictionary evolution (vectorized, same serial outcome)
            if add_rule_threshold:
                nd = len(dictionary)
                if nd:
                    ds = (dict_rows[:nd] ^ P.reshape(M)[None, :]).sum(
                        axis=1, dtype=np.int32)
                    bestd = int(ds.min())
                else:
                    bestd = M + 1
                if bestd > T:
                    dict_rows[nd] = P.reshape(M)
                    dictionary.append((i0, j0))
            else:
                if not match:
                    dict_rows[len(dictionary)] = P.reshape(M)
                    dictionary.append((i0, j0))
    return grid[:rows, :cols].astype(bool)


# ---------------------------------------------------------------------------
# codec 10: full-image MED + adaptive run-length (bitplane workhorse)
# ---------------------------------------------------------------------------

def _medrle_runs(img: np.ndarray, residual: np.ndarray | None = None
                 ) -> np.ndarray:
    """Zero-run lengths of the MED residual in raster order (incl. the
    trailing run when nonempty) — the codec-10 symbol stream."""
    if residual is None:
        residual = _med(np.asarray(img, dtype=np.uint8))
    flat = residual.ravel()
    ones = np.flatnonzero(flat)
    gaps = np.diff(np.concatenate([[-1], ones])) - 1
    trailing = flat.size - (int(ones[-1]) + 1) if ones.size else flat.size
    if trailing > 0:  # decoder stops on pixel count; zero tail needs no run
        gaps = np.concatenate([gaps, [trailing]])
    return gaps.astype(np.int64)


def _encode_medrle(img: np.ndarray,
                   residual: np.ndarray | None = None) -> bytes:
    """MED + adaptive run-length (codec 10).  The MED residual is vectorized
    numpy (or device-computed and passed in by the device bitplane pipeline,
    compress.encode_pgm_tpu); the run loop is native C++ with a Python
    fallback."""
    rows, cols = img.shape
    params = CodecParams(codec=10, W=0, T=0, R=0)
    hdr = _header(params, rows, cols, image_crc(img))
    runs = _medrle_runs(img, residual)
    from .. import native
    payload = native.eg_encode_runs(runs)
    if payload is not None:
        return hdr + payload
    w = BitWriter()
    w.write_bits(int.from_bytes(hdr, "big"), len(hdr) * 8)
    eg = _EGStream(w)
    for g in runs:
        eg.encode_run(int(g))
    return w.getvalue()


def _decode_medrle_payload(payload: bytes, rows: int, cols: int
                           ) -> np.ndarray:
    n = rows * cols
    from .. import native
    flat = native.eg_decode_runs(payload, n)
    if flat is None:
        r = BitReader(payload)
        flat = np.zeros(n, dtype=np.uint8)
        eg = _EGStream(None, reader=r)
        pos = 0
        while pos < n:
            run = eg.decode_run(n - pos)
            pos += run
            if pos < n:
                flat[pos] = 1
                pos += 1
    return _unmed(flat.reshape(rows, cols).astype(bool))


class _EGStream:
    """Adaptive exp-Golomb run codec (the reference's intended MELCODE with
    incBlockSize enabled and the LUT clamped — eg.cpp:4-10, DEVIATIONS.md 2).

    A run of z zeros is coded as one '1' per full current block (growing the
    block) then '0' + g-bit remainder (shrinking).  The final run is coded
    the same way; the decoder stops on total pixel count, so no EOL flag is
    needed."""

    from ..ops.entropy import EGLUT as _LUT

    def __init__(self, writer, reader=None):
        self.w = writer
        self.r = reader
        self.lut_index = 0
        self.g = 1        # eg.h ctor state
        self.block = 1

    def _inc(self):
        if self.lut_index < 31:
            self.lut_index += 1
        self.g = self._LUT[self.lut_index]
        self.block = 1 << self.g

    def _dec(self):
        if self.lut_index > 0:
            self.lut_index -= 1
        self.g = self._LUT[self.lut_index]
        self.block = 1 << self.g

    def encode_run(self, length: int):
        while length >= self.block:
            length -= self.block
            self.w.write_bits(1, 1)
            self._inc()
        self.w.write_bits(0, 1)
        self.w.write_bits(length, self.g)
        self._dec()

    def decode_run(self, maxlen: int) -> int:
        length = 0
        while self.r.read_bits(1):
            length += self.block
            self._inc()
            if length > maxlen:
                return maxlen
        length += self.r.read_bits(self.g)
        self._dec()
        return length


# ---------------------------------------------------------------------------
# grayscale (PGM) container: per-bitplane BIC1 streams
# ---------------------------------------------------------------------------

PGM_MAGIC = b"BICG"


def encode_pgm(gray: np.ndarray, maxval: int,
               params: CodecParams | None = None, *,
               gray_code: bool = True, backend: str = "host") -> bytes:
    """Grayscale codec: bitplane decomposition (the bitplane_tool path,
    bitplane_tool.cpp:24-39) + one BIC1 stream per plane.

    gray_code=True XORs adjacent planes first (g = v ^ (v >> 1)) — the
    standard trick that decorrelates bitplanes and which the reference's
    plane pipeline lacks; typically 10-20% smaller on smooth images.

    backend="tpu" runs every plane's MED prediction batched on device in one
    compiled program (models/compress.med_planes) with the run-length stage
    in native C++ — byte-identical to the host codec-10 path (tests).
    backend="tpu-device-assembly" additionally runs the adaptive-EG coding
    and the parallel-prefix bit packing on device (the whole payload as one
    jit, ops/egdevice + ops/bitstream.pack_varlen) — same bytes; slower in
    wall clock today (the LUT-adaptation scan dominates) but needs no native
    lib and scales with the device mesh.

    backend="tpu-rans" encodes every plane as a codec-13 mode-2 stream
    with ONE vmapped device jit (the round-5 rANS coder,
    compress.encode_planes_rans) — the entire entropy stage for the whole
    stack on chip, typically the best ratio of the plane codecs on
    doc-class planes."""
    from ..utils import bitplanes
    gray = np.asarray(gray, dtype=np.uint32)
    if gray_code:
        gray = gray ^ (gray >> 1)
    planes = bitplanes.decompose(gray, maxval)
    if backend == "tpu-rans":
        from . import compress as compress_mod
        blobs = compress_mod.encode_planes_rans(
            planes, params if params is not None and params.codec == 13
            else None)
    elif backend in ("tpu", "tpu-device-assembly") and (
            params is None or params.codec == 10):
        from . import compress as compress_mod
        blobs = compress_mod.encode_planes_device(
            planes,
            "device" if backend == "tpu-device-assembly" else "native")
    elif params is None:
        # per-plane best-of: smooth high planes favor the arithmetic codec,
        # noisy low planes the run-length codec; pick by actual bytes
        cand = [CodecParams(codec=13, W=0, T=0, R=0),
                CodecParams(codec=10, W=0)]
        blobs = [min((encode(p, c) for c in cand), key=len)
                 for p in planes]
    else:
        blobs = [encode(p, params) for p in planes]
    out = bytearray()
    out += PGM_MAGIC
    out += struct.pack("<BBH", len(blobs), 1 if gray_code else 0, maxval)
    for b in blobs:
        out += struct.pack("<I", len(b))
    for b in blobs:
        out += b
    return bytes(out)


def decode_pgm(blob: bytes) -> tuple[np.ndarray, int]:
    from ..utils import bitplanes
    if blob[:4] != PGM_MAGIC:
        raise ValueError("not a BICG stream")
    nplanes, gflag, maxval = struct.unpack("<BBH", blob[4:8])
    lens = struct.unpack(f"<{nplanes}I", blob[8:8 + 4 * nplanes])
    off = 8 + 4 * nplanes
    spans = []
    for ln in lens:
        spans.append(blob[off:off + ln])
        off += ln
    # planes are independent streams and the native decoders drop the GIL:
    # decode them in parallel across host cores
    import os
    from concurrent.futures import ThreadPoolExecutor
    workers = min(len(spans), os.cpu_count() or 1)
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            planes = list(ex.map(decode, spans))
    else:
        planes = [decode(s) for s in spans]
    gray = bitplanes.recompose(np.stack(planes))
    if gflag:
        # inverse gray code: v = g ^ (g>>1) ^ (g>>2) ...
        v = gray.copy()
        shift = 1
        while (maxval >> shift) > 0 or shift < 32:
            v ^= gray >> shift
            shift += 1
            if shift > 31:
                break
        gray = v
    return gray, maxval


# ---------------------------------------------------------------------------
# codec 11: learned binary dictionary (BSVD) patch codec
# ---------------------------------------------------------------------------

def _encode_bsvd(img, params, *, K=64, learn_backend="tpu",
                 seed=34503498) -> bytes:
    """The codec the reference's patch_compress.cpp aimed at (it does not
    compile — SURVEY.md §2.6): learn a GF(2) dictionary over the page's
    patches, then code each patch as its coefficient set + sparse residual.

    Stream: header | K:u16 | dictionary (per atom: golomb weight + enum
    rank) | per patch: golomb #coefs (ctx c), enum rank of the coef set
    over C(K, k_i), golomb residual weight (ctx r), enum residual rank.
    """
    from . import bsvd as bsvd_tpu
    from . import bsvd_ref
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    W = params.W
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    grid = np.zeros((ny * W, nx * W), dtype=bool)
    grid[:rows, :cols] = img
    X = grid.reshape(ny, W, nx, W).swapaxes(1, 2).reshape(ny * nx, M)
    if learn_backend == "tpu":
        import jax.numpy as jnp
        E, D, A, _ = bsvd_tpu.learn(jnp.asarray(X, dtype=np.int8), K=K,
                                    init="random_centroids", seed=seed)
        E = np.asarray(E, dtype=bool)
        D = np.asarray(D, dtype=bool)
        A = np.asarray(A, dtype=bool)
    else:
        bsvd_ref.reset_rng(seed)
        D = np.zeros((K, M), dtype=bool)
        A = np.zeros((X.shape[0], K), dtype=bool)
        bsvd_ref.initialize_random_centroids(X, D, A)
        E = np.zeros_like(X)
        bsvd_ref.learn_traditional(X, E, D, A,
                                   bsvd_ref.update_coefficients,
                                   bsvd_ref.update_dictionary_steepest)

    w = BitWriter()
    hdr = _header(params, rows, cols, image_crc(img))
    w.write_bits(int.from_bytes(hdr, "big"), len(hdr) * 8)
    w.write_bits(K, 16)
    gd = GolombCoder()
    for k in range(K):
        wt = int(D[k].sum())
        golomb_encode(w, wt, gd.k)
        gd.code_sample(wt)
        enum_encode(w, D[k])
    gc, gr = GolombCoder(), GolombCoder()
    for i in range(X.shape[0]):
        coefs = A[i]
        nc = int(coefs.sum())
        golomb_encode(w, nc, gc.k)
        gc.code_sample(nc)
        enum_encode(w, coefs)
        wt = int(E[i].sum())
        golomb_encode(w, wt, gr.k)
        gr.code_sample(wt)
        enum_encode(w, E[i])
    return w.getvalue()


def _decode_bsvd(r: BitReader, W, rows, cols):
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    K = r.read_bits(16)
    gd = GolombCoder()
    D = np.zeros((K, M), dtype=bool)
    for k in range(K):
        wt = golomb_decode(r, gd.k)
        gd.code_sample(wt)
        D[k] = enum_decode(r, M, wt)
    Dint = D.astype(np.int64)
    gc, gr = GolombCoder(), GolombCoder()
    out = np.zeros((ny * W, nx * W), dtype=bool)
    li = 0
    for ti in range(ny):
        for tj in range(nx):
            nc = golomb_decode(r, gc.k)
            gc.code_sample(nc)
            coefs = enum_decode(r, K, nc)
            wt = golomb_decode(r, gr.k)
            gr.code_sample(wt)
            E = enum_decode(r, M, wt)
            patch = ((coefs.astype(np.int64) @ Dint) % 2 == 1) ^ E
            out[ti * W:(ti + 1) * W, tj * W:(tj + 1) * W] = \
                patch.reshape(W, W)
            li += 1
    return out[:rows, :cols]


# ---------------------------------------------------------------------------
# codec 12: JBIG-class context-adaptive arithmetic coding ("cabic")
# ---------------------------------------------------------------------------

def _ctx_template(img_u8, r, c, rows, cols):
    def px(rr, cc):
        if rr < 0 or cc < 0 or cc >= cols:
            return 0
        return int(img_u8[rr, cc])
    return ((px(r - 2, c - 1) << 9) | (px(r - 2, c) << 8)
            | (px(r - 2, c + 1) << 7) | (px(r - 1, c - 2) << 6)
            | (px(r - 1, c - 1) << 5) | (px(r - 1, c) << 4)
            | (px(r - 1, c + 1) << 3) | (px(r - 1, c + 2) << 2)
            | (px(r, c - 2) << 1) | px(r, c - 1))


def _encode_cabic(img, params) -> bytes:
    """10-bit causal-template adaptive arithmetic coding — the beyond-
    reference entropy stage (typically 25-50% smaller than the windowed
    codecs on documents, and faster).  Native C++ coder with a Python
    twin fallback (ops/entropy.RangeEncoder)."""
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    hdr = _header(params, rows, cols, image_crc(img))
    from .. import native
    body = native.cabic_encode(img.astype(np.uint8))
    if body is None:
        from ..ops.entropy import RangeEncoder, cabac_model_update
        prob = [0x8000] * 1024
        rc = RangeEncoder()
        u8 = img.astype(np.uint8)
        for r in range(rows):
            for c in range(cols):
                ctx = _ctx_template(u8, r, c, rows, cols)
                bit = int(u8[r, c])
                rc.encode_bit(prob[ctx], bit)
                prob[ctx] = cabac_model_update(prob[ctx], bit)
        body = rc.finish()
    return hdr + body


def _decode_cabic(blob_body: bytes, rows: int, cols: int) -> np.ndarray:
    from .. import native
    out = native.cabic_decode(blob_body, rows, cols)
    if out is None:
        from ..ops.entropy import RangeDecoder, cabac_model_update
        prob = [0x8000] * 1024
        rd = RangeDecoder(blob_body)
        u8 = np.zeros((rows, cols), dtype=np.uint8)
        for r in range(rows):
            for c in range(cols):
                ctx = _ctx_template(u8, r, c, rows, cols)
                bit = rd.decode_bit(prob[ctx])
                prob[ctx] = cabac_model_update(prob[ctx], bit)
                u8[r, c] = bit
        out = u8.astype(bool)
    return out


# ---------------------------------------------------------------------------
# codec 13: stripe-parallel context-adaptive arithmetic coding ("scab")
# ---------------------------------------------------------------------------

def scab_defaults(params: CodecParams, rows: int) -> tuple[int, int]:
    """(template_bits, n_stripes) for codec 13.  params.W selects the
    template when it is 10 or 12 (default 12 — two extra causal neighbors,
    px(r-1,c+3) and px(r,c-3)); params.T the stripe count (0 = auto: one
    stripe per 128 rows, clamped to [1, 16] — 15,097 B on doc512 vs codec
    12's 16,181 B)."""
    tmpl = params.W if params.W in (10, 12) else 12
    n_stripes = params.T if params.T else max(1, min(16, rows // 128))
    return tmpl, min(n_stripes, rows)


def _scab_ctx(u8, r, c, top, cols, tmpl):
    """Per-pixel template (Python twin of the native incremental scan):
    codec-12's 10-bit JBIG template, with reads above the STRIPE top (not
    just the image top) returning 0; tmpl 12 appends px(r-1,c+3) and
    px(r,c-3).  Bit layout matches native scan_stripe exactly."""
    def px(rr, cc):
        if rr < top or cc < 0 or cc >= cols:
            return 0
        return int(u8[rr, cc])
    base = ((px(r - 2, c - 1) << 9) | (px(r - 2, c) << 8)
            | (px(r - 2, c + 1) << 7) | (px(r - 1, c - 2) << 6)
            | (px(r - 1, c - 1) << 5) | (px(r - 1, c) << 4)
            | (px(r - 1, c + 1) << 3) | (px(r - 1, c + 2) << 2)
            | (px(r, c - 2) << 1) | px(r, c - 1))
    if tmpl == 10:
        return base
    # tmpl 12: a3<<9 | b6<<3 | cur3 (see native scan_stripe)
    a3 = base >> 7
    b5 = (base >> 2) & 31
    cur2 = base & 3
    return (a3 << 9) | (((b5 << 1) | px(r - 1, c + 3)) << 3) \
        | (px(r, c - 3) << 2) | cur2


def _encode_scab(img, params, ctx_pre=None) -> bytes:
    """Codec 13: the codec-12 entropy stage re-engineered for parallel
    hardware.  Horizontal stripes are INDEPENDENT arithmetic streams
    (template reads above the stripe top are 0, models start fresh), so
    encode/decode parallelize across host threads and the per-pixel context
    ids can be computed on device for the whole page
    (models/compress.encode_scab); count-ramped adaptation warms each
    stripe's model in tens of pixels.  Native C++ with a Python twin.

    ctx_pre: optional uint16 [rows, cols] precomputed context map (the
    device path); must equal the incremental scan's contexts."""
    from ..ops.entropy import RangeEncoder, scab_model_update
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    hdr = _header(params, rows, cols, image_crc(img))
    tmpl, n_stripes = scab_defaults(params, rows)
    from .. import native
    body = native.scab_encode(img.astype(np.uint8), tmpl, n_stripes,
                              ramp=True, ctx_pre=ctx_pre)
    if body is not None:
        return hdr + body
    # pure-Python twin (slow; conformance oracle for the C++ coder)
    stripe_rows = -(-rows // n_stripes)
    n_stripes = -(-rows // stripe_rows)
    u8 = img.astype(np.uint8)
    streams = []
    for s in range(n_stripes):
        top = s * stripe_rows
        bot = min(rows, top + stripe_rows)
        prob = [0x8000] * (1 << tmpl)
        cnt = [0] * (1 << tmpl)
        rc = RangeEncoder()
        for r in range(top, bot):
            for c in range(cols):
                ctx = (int(ctx_pre[r, c]) if ctx_pre is not None
                       else _scab_ctx(u8, r, c, top, cols, tmpl))
                bit = int(u8[r, c])
                rc.encode_bit(prob[ctx], bit)
                prob[ctx], cnt[ctx] = scab_model_update(
                    prob[ctx], cnt[ctx], bit, ramp=True)
        streams.append(rc.finish())
    body = bytearray()
    body += struct.pack("<BBHi", tmpl, 1, n_stripes, stripe_rows)
    for b in streams:
        body += struct.pack("<I", len(b))
    for b in streams:
        body += b
    return hdr + bytes(body)


def _decode_scab(body: bytes, rows: int, cols: int) -> np.ndarray:
    if len(body) >= 2 and body[1] == 2:      # mode 2: static-table rANS
        return _decode_scab_rans(body, rows, cols)
    from .. import native
    out = native.scab_decode(body, rows, cols)
    if out is not None:
        return out
    from ..ops.entropy import RangeDecoder, scab_model_update
    if len(body) < 8:
        raise ValueError("truncated codec-13 payload")
    tmpl, ramp, n_stripes, stripe_rows = struct.unpack("<BBHi", body[:8])
    if tmpl not in (10, 12) or n_stripes < 1 or stripe_rows < 1 \
            or (n_stripes - 1) * stripe_rows >= rows \
            or n_stripes * stripe_rows < rows:
        raise ValueError("corrupt codec-13 payload header")
    lens = struct.unpack(f"<{n_stripes}I", body[8:8 + 4 * n_stripes])
    off = 8 + 4 * n_stripes
    u8 = np.zeros((rows, cols), dtype=np.uint8)
    for s in range(n_stripes):
        top = s * stripe_rows
        bot = min(rows, top + stripe_rows)
        rd = RangeDecoder(body[off:off + lens[s]])
        off += lens[s]
        prob = [0x8000] * (1 << tmpl)
        cnt = [0] * (1 << tmpl)
        for r in range(top, bot):
            for c in range(cols):
                ctx = _scab_ctx(u8, r, c, top, cols, tmpl)
                bit = rd.decode_bit(prob[ctx])
                prob[ctx], cnt[ctx] = scab_model_update(
                    prob[ctx], cnt[ctx], bit, ramp=bool(ramp))
                u8[r, c] = bit
    return u8.astype(bool)


def _decode_scab_rans(body: bytes, rows: int, cols: int) -> np.ndarray:
    """Decode the mode-2 (device-assembled static-table interleaved-rANS)
    codec-13 payload — see compress._encode_scab_device for the layout and
    ops/ransdevice for the coder maths.  Native C++ fast path
    (bic_scab_rans_decode) with this Python twin as the oracle/fallback.
    Decode is serial per stripe by construction (contexts come from
    already-decoded pixels); stripes decode in parallel host threads via
    the native path."""
    from .. import native
    out = native.scab_rans_decode(body, rows, cols)
    if out is not None:
        return out
    from ..ops.bitstream import golomb_decode
    from ..ops.ransdevice import CODE_BITS, LOGIT64, PSCALE
    if len(body) < 16:
        raise ValueError("truncated codec-13 mode-2 payload")
    tmpl, mode, n_stripes, stripe_rows = struct.unpack("<BBHi", body[:8])
    n_lanes, q_def, n_tr = struct.unpack("<BBH", body[8:12])
    bm_mode, rice_k, bm_len = struct.unpack("<BBH", body[12:16])
    if tmpl not in (10, 12) or mode != 2 or n_stripes < 1 \
            or stripe_rows < 1 or n_lanes < 1 or q_def > 63 \
            or n_tr > PSCALE or bm_mode > 1 or rice_k > 12 \
            or (n_stripes - 1) * stripe_rows >= rows \
            or n_stripes * stripe_rows < rows:
        raise ValueError("corrupt codec-13 mode-2 payload header")
    off = 16
    if len(body) < off + bm_len:
        raise ValueError("truncated codec-13 mode-2 bitmap")
    if bm_mode == 0:
        if bm_len != 512:
            raise ValueError("corrupt codec-13 mode-2 bitmap")
        transmit = np.unpackbits(
            np.frombuffer(body[off:off + 512], np.uint8)).astype(bool)
        ids = np.flatnonzero(transmit)
    else:
        br = BitReader(body[off:off + bm_len])
        ids = np.empty(n_tr, np.int64)
        prev = -1
        try:
            for i in range(n_tr):
                prev = prev + 1 + golomb_decode(br, rice_k)
                ids[i] = prev
        except IndexError:
            raise ValueError("corrupt codec-13 mode-2 bitmap") from None
        if n_tr and ids[-1] >= PSCALE:
            raise ValueError("corrupt codec-13 mode-2 bitmap")
    off += bm_len
    code_bytes = (n_tr * CODE_BITS + 7) // 8
    if len(ids) != n_tr or len(body) < off + code_bytes:
        raise ValueError("corrupt codec-13 mode-2 table")
    rd = BitReader(body[off:off + code_bytes])
    table = np.full(PSCALE, LOGIT64[q_def], np.uint32)
    for c in ids:
        table[c] = LOGIT64[rd.read_bits(CODE_BITS)]
    off += code_bytes
    if len(body) < off + 4 * n_stripes:
        raise ValueError("truncated codec-13 mode-2 payload")
    lens = struct.unpack(f"<{n_stripes}I", body[off:off + 4 * n_stripes])
    off += 4 * n_stripes
    u8 = np.zeros((rows, cols), np.uint8)
    for s in range(n_stripes):
        blob = body[off:off + lens[s]]
        off += lens[s]
        if len(blob) < 4 * n_lanes:
            raise ValueError("truncated codec-13 mode-2 stripe")
        states = np.frombuffer(blob[:4 * n_lanes], "<u4").copy()
        stream = blob[4 * n_lanes:]
        pos = 0
        top = s * stripe_rows
        bot = min(rows, top + stripe_rows)
        t = 0
        for r in range(top, bot):
            for c in range(cols):
                lane = t % n_lanes
                x = int(states[lane])
                ctx = _scab_ctx(u8, r, c, top, cols, tmpl)
                p1 = int(table[ctx])
                f0 = PSCALE - p1
                slot = x & (PSCALE - 1)
                bit = 1 if slot >= f0 else 0
                f, b = (p1, f0) if bit else (f0, 0)
                x = f * (x >> 12) + slot - b
                if x < (1 << 16):
                    if pos + 1 >= len(stream):
                        raise ValueError("corrupt codec-13 mode-2 stream")
                    x = (x << 16) | (stream[pos] << 8) | stream[pos + 1]
                    pos += 2
                states[lane] = x
                u8[r, c] = bit
                t += 1
    return u8.astype(bool)


# ---------------------------------------------------------------------------
# color (PPM) container: per-channel BICG streams
# ---------------------------------------------------------------------------

PPM_MAGIC = b"BICC"


def encode_ppm(rgb_packed: np.ndarray, maxval: int,
               params: CodecParams | None = None, *,
               backend: str = "host") -> bytes:
    """Color codec: 0xRRGGBB-packed uint32 [rows, cols] (the reference's
    pixel_t layout, pnm.cpp:214) -> three per-channel bitplane streams."""
    img = np.asarray(rgb_packed, dtype=np.uint32)
    chans = [(img >> 16) & 0xFF, (img >> 8) & 0xFF, img & 0xFF]
    blobs = [encode_pgm(c, maxval, params, backend=backend) for c in chans]
    out = bytearray(PPM_MAGIC)
    out += struct.pack("<H", maxval)
    for b in blobs:
        out += struct.pack("<I", len(b))
    for b in blobs:
        out += b
    return bytes(out)


def decode_ppm(blob: bytes) -> tuple[np.ndarray, int]:
    if blob[:4] != PPM_MAGIC:
        raise ValueError("not a BICC stream")
    (maxval,) = struct.unpack("<H", blob[4:6])
    lens = struct.unpack("<3I", blob[6:18])
    off = 18
    chans = []
    for ln in lens:
        g, _ = decode_pgm(blob[off:off + ln])
        chans.append(g)
        off += ln
    r, g, b = chans
    return (r.astype(np.uint32) << 16) | (g.astype(np.uint32) << 8) \
        | b.astype(np.uint32), maxval
