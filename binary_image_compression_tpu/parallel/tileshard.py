"""Tile-row sharding of ONE image's windowed-search analysis across devices.

The reference's only parallelism is OpenMP threads over samples
(bsvd.cpp:1057); its codecs are strictly serial.  This module is the
spatial ("context") parallelism for the causal-original codec mode: the tile
grid is sharded by tile ROWS over the mesh's ``data`` axis, and each shard
pulls the R-row causal context above its block from its up-neighbors with
lax.ppermute — the halo-exchange plan of SURVEY.md §2.10 applied to
the raster causality contract of the reference search
(/root/reference/src/compress8_test.cpp:137-143, pred.cpp:6-14).

Causal-original mode reads only decoded ORIGINAL pixels, so the search is a
pure function of the image: sharding is exact, and the resulting stream is
byte-identical to the single-device encoder
(tests/test_tileshard.py; also exercised in __graft_entry__.dryrun_multichip).

Halo depth R may exceed one shard's row block: the halo is gathered in
ceil(R / block_rows) ppermute hops (multi-hop ring shift), all static.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import search
from ..models import compress


def _analyze_shard(block, *, n: int, W: int, R: int, T_thresh: int,
                   rows: int, cols: int, gw: int, block_rows: int,
                   invert: bool):
    """Per-shard body: halo pull + banded search + shared selection."""
    idx = lax.axis_index("data")
    base = idx * block_rows

    # ---- multi-hop halo: R rows of causal context from the shards above --
    hops = -(-R // block_rows)
    parts = [block]
    for hop in range(1, hops + 1):
        perm = [(i, i + hop) for i in range(n - hop)]
        moved = lax.ppermute(block, "data", perm) if perm else \
            jnp.zeros_like(block)
        moved = jnp.where(idx >= hop, moved, jnp.zeros_like(moved))
        parts.insert(0, moved)
    ext = jnp.concatenate(parts, axis=0)[-(R + block_rows):]  # [R+blk, gw]

    # ---- local tile origins (ext-relative) and absolute twins ------------
    ny_loc = block_rows // W
    nx = gw // W
    ii, jj = jnp.meshgrid(jnp.arange(ny_loc), jnp.arange(nx), indexing="ij")
    i0_rel = (R + ii * W).ravel()
    j0 = (jj * W).ravel()

    # causal masks / scan-order ranks use ABSOLUTE coordinates so the
    # sharded streams match the single-device enumeration exactly; bands
    # and patch gathers stay ext-frame-relative.  Ext rows above the image
    # (the zero halo of the top shards) land at negative absolute y and are
    # masked off by the key grids.
    from ..ops import fused_search
    if fused_search.fused_supported(W, R, cols):
        sel, oy_rel, ox, plane = fused_search.search_select(
            ext, i0_rel, j0, ny_loc, nx, W=W, R=R, T_thresh=T_thresh,
            rows=rows, cols=cols, invert=invert, y_base=base - R)
        if 32 % W == 0 and W * W >= 32:
            return compress._finish_selection_fields(
                plane, sel, (i0_rel, j0, oy_rel, ox), W=W, invert=invert)
        return compress._finish_selection(ext, sel, (i0_rel, j0, oy_rel, ox),
                                          W=W, invert=invert)
    i0_abs = i0_rel + base - R
    d, oy_rel, ox = search.window_distance_maps_banded(
        ext, i0_rel, j0, W, R, ny_loc, nx)
    oy_abs = oy_rel + base - R
    return compress._select_and_pack(
        ext, d, (i0_abs, j0, oy_abs, ox), (i0_rel, j0, oy_rel, ox),
        W=W, R=R, T_thresh=T_thresh, invert=invert, rows=rows, cols=cols)


def analyze_tile_sharded(mesh: Mesh, img_grid, *, W: int, R: int,
                         T_thresh: int, rows: int, cols: int,
                         invert: bool = True):
    """Windowed-search analysis of one image, tile-rows sharded over 'data'.

    img_grid: 0/1 [gh, gw] padded tile grid (gh = ny*W, gw = nx*W); gh is
    zero-padded up to a multiple of the shard count (appended rows produce
    extra all-zero tile rows whose records the caller drops — zero-pad tiles
    are causally AFTER every real tile, so they cannot change real tiles'
    candidate sets).  Returns the encode_analyze dict for the PADDED grid's
    ny_pad*nx tiles in raster order.
    """
    n = mesh.shape["data"]
    img_grid = jnp.asarray(img_grid, jnp.int8)
    gh, gw = img_grid.shape
    ny = gh // W
    # pad tile rows to a multiple of the shard count
    ny_pad = -(-ny // n) * n
    if ny_pad != ny:
        img_grid = jnp.pad(img_grid, ((0, (ny_pad - ny) * W), (0, 0)))
        gh = ny_pad * W
    block_rows = gh // n

    sharded = _sharded_fn(mesh, n, W, R, T_thresh, rows, cols, gw,
                          block_rows, invert)
    grid = jax.device_put(img_grid, NamedSharding(mesh, P("data", None)))
    return sharded(grid), ny_pad


@lru_cache(maxsize=32)
def _sharded_fn(mesh, n, W, R, T_thresh, rows, cols, gw, block_rows,
                invert):
    fn = partial(_analyze_shard, n=n, W=W, R=R, T_thresh=T_thresh,
                 rows=rows, cols=cols, gw=gw, block_rows=block_rows,
                 invert=invert)
    out_specs = dict(rank=P("data"), n_cands=P("data"), inv=P("data"),
                     has_cands=P("data"), weights4=P("data", None),
                     idx_len=P("data"), residual4=P("data", None, None))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=P("data", None),
                             out_specs=out_specs))


def encode_tile_sharded(mesh: Mesh, img: np.ndarray, params=None) -> bytes:
    """Full encode with the analysis tile-sharded across the mesh; stream is
    byte-identical to models/compress.encode on one device."""
    from ..models.codec import CodecParams, _header, image_crc
    params = params or CodecParams(codec=8, strict=False)
    assert params.codec in (4, 7, 8) and not params.strict
    assert params.R >= params.W, "device band geometry requires R >= W"
    compress._check_W(params)
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    W = params.W
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((ny * W, nx * W), dtype=np.int8)
    grid[:rows, :cols] = img
    out, ny_pad = analyze_tile_sharded(
        mesh, grid, W=W, R=params.R, T_thresh=params.resolved_T(),
        rows=rows, cols=cols, invert=params.codec == 8)
    out = jax.device_get(out)
    if ny_pad != ny:  # drop the shard-padding tile rows' records
        keep = ny * nx
        out = {k: v[:keep] for k, v in out.items()}
    hdr = _header(params, rows, cols, image_crc(img))
    return compress._assemble(out, hdr, W * W, ny * nx, params.codec)
