"""The windowed search on the packed field plane (ops/fused_search) and the
banded masked-grid selection must agree bit for bit, on whole images, on
halo frames of a tile-sharded image and under vmap."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from binary_image_compression_tpu.models import compress
from binary_image_compression_tpu.ops import fused_search as fs
from binary_image_compression_tpu.ops import search


def _grid(rng, rows, cols, W, density):
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((ny * W, nx * W), dtype=np.int8)
    grid[:rows, :cols] = rng.rand(rows, cols) < density
    return grid


def _analyze(grid, variant, **kw):
    return jax.device_get(compress.encode_analyze(jnp.asarray(grid),
                                                  variant=variant, **kw))


@pytest.mark.parametrize("case", [
    # rows, cols, W, R, T_thresh, invert, density
    (64, 64, 16, 24, 1, True, 0.3),
    (100, 90, 16, 32, 5, True, 0.1),      # ragged dims
    (48, 48, 8, 16, 0, True, 0.5),
    (96, 128, 32, 40, 2, True, 0.2),
    (80, 80, 16, 128, 1, True, 0.05),     # R larger than the image
    (33, 70, 16, 24, 300, False, 0.4),    # huge T: every candidate stops
    (64, 200, 8, 16, 1, True, 0.3),       # several tile groups per row
    (48, 250, 8, 16, 2, True, 0.2),       # groups + ragged tile pad
])
def test_packed_selection_matches_grid(rng, case):
    """The single-reduction packed-priority selection (closed-form ranks,
    key-decoded coordinates) is bit-identical to the masked-grid selection
    over banded distance maps."""
    rows, cols, W, R, T_thresh, invert, density = case
    grid = _grid(rng, rows, cols, W, density)
    assert fs.packed_sel_layout(W, R, cols) is not None
    kw = dict(W=W, R=R, T_thresh=T_thresh, rows=rows, cols=cols,
              invert=invert)
    want = _analyze(grid, "banded", **kw)
    got = _analyze(grid, "fused", **kw)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dims", [
    (75, 101, 8, 24),     # ragged dims, single group
    (64, 230, 8, 16),     # several groups with a padded final group
])
def test_fused_search_matches_banded(rng, dims):
    """Field-plane search (XOR+popcount + packed selection) == banded maps
    + selection, on ragged dims, through the default variant."""
    rows, cols, W, R = dims
    grid = _grid(rng, rows, cols, W, 0.35)
    kw = dict(W=W, R=R, T_thresh=1, rows=rows, cols=cols)
    a = _analyze(grid, "fused", **kw)
    b = _analyze(grid, "banded", **kw)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _select(grid, rows, cols, W, R, *, y_base=None, i0_shift=0,
            T_thresh=1, invert=True):
    gh, gw = grid.shape
    ny, nx = (gh - i0_shift) // W, gw // W
    i0, j0, _, _ = search.tile_origins(ny * W, nx * W, W)
    sel, oy, ox, _ = fs.search_select(
        jnp.asarray(grid), i0 + i0_shift, j0, ny, nx, W=W, R=R,
        T_thresh=T_thresh, rows=rows, cols=cols, invert=invert,
        y_base=y_base)
    return jax.device_get((sel, oy))


@pytest.mark.parametrize("W,R,rows,cols,dens", [
    (4, 8, 40, 52, 0.3),
    (4, 33, 37, 61, 0.2),
    (8, 16, 64, 64, 0.3),
    (8, 40, 75, 101, 0.1),
    (16, 16, 48, 80, 0.4),
    (16, 64, 100, 90, 0.2),
    (16, 100, 64, 300, 0.05),
    (32, 32, 64, 96, 0.3),
    (32, 70, 96, 128, 0.2),
])
def test_field_search_matches_banded_all_packings(rng, W, R, rows, cols,
                                                  dens):
    """The field-plane search == the banded search, over field packings
    k = 4, 4, 2, 1 (W = 4, 8, 16, 32), several radii and ragged images."""
    grid = _grid(rng, rows, cols, W, dens)
    kw = dict(W=W, R=R, T_thresh=1, rows=rows, cols=cols)
    a = _analyze(grid, "fused", **kw)
    b = _analyze(grid, "banded", **kw)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("y_base,shift", [(-16, 16), (40, 16), (-24, 24)])
def test_halo_frame_matches_whole_image(rng, y_base, shift):
    """A halo-extended frame (parallel/tileshard): `shift` halo rows, then
    4 tile rows, frame row 0 at absolute row y_base (zeros above the
    image).  Every tile selects what it selects in the whole image."""
    W, R, rows, cols = 8, 16, 200, 72
    img = _grid(rng, rows, cols, W, 0.3)
    t0 = (y_base + shift) // W                  # first tile row of the shard
    frame = np.zeros((shift + 4 * W, img.shape[1]), np.int8)
    lo = max(y_base, 0)
    frame[lo - y_base:] = img[lo:(t0 + 4) * W]
    nx = img.shape[1] // W
    part = slice(t0 * nx, (t0 + 4) * nx)
    for invert in (True, False):
        sel, oy = _select(frame, rows, cols, W, R, y_base=y_base,
                          i0_shift=shift, invert=invert)
        fsel, foy = _select(img, rows, cols, W, R, invert=invert)
        for k in sel:
            if k != "dy":
                np.testing.assert_array_equal(sel[k], fsel[k][part],
                                              err_msg=k)
        found = sel["found"]
        np.testing.assert_array_equal(
            np.where(found, oy + sel["dy"] + y_base, 0),
            np.where(found, foy[part] + fsel["dy"][part], 0))


def test_vmapped_search_matches_per_page(rng):
    """vmap (encode_batch(vmapped=True), mesh.sharded_encode_analyze) of
    the analysis == the analysis of each page alone."""
    W, R, rows, cols = 8, 16, 40, 75
    pages = np.stack([_grid(rng, rows, cols, W, 0.3) for _ in range(3)])
    kw = dict(W=W, R=R, T_thresh=1, rows=rows, cols=cols)
    out = jax.device_get(jax.vmap(lambda g: compress.encode_analyze(
        g, **kw))(jnp.asarray(pages)))
    for b, page in enumerate(pages):
        want = _analyze(page, "fused", **kw)
        for k in want:
            np.testing.assert_array_equal(out[k][b], want[k],
                                          err_msg=f"{b} {k}")


def test_fused_supported_wide_grids_and_layout():
    """Scan keys are window-relative, so the packed layout covers wide
    pages; R < W and W > 32 fall back to the banded search."""
    assert fs.fused_supported(16, 128, 2480)     # A4 at 300 dpi
    assert fs.packed_sel_layout(16, 128, 2048) is not None
    assert fs.packed_sel_layout(16, 128, 100000) is not None
    # R < W: band geometry cannot cover grid-1 rows — not supported
    assert not fs.fused_supported(16, 8, 512)
    assert fs.packed_sel_layout(16, 8, 512) is None
    assert not fs.fused_supported(48, 128, 512)
    # a radius whose keys overflow the int32 layout
    assert fs.packed_sel_layout(32, 256, 512) is None


@pytest.mark.parametrize("nx,W,R", [(32, 16, 128), (155, 16, 128),
                                    (7, 8, 16), (64, 32, 64), (3, 4, 8),
                                    (1, 16, 16), (33, 16, 128)])
def test_search_columns_cover_windows(nx, W, R):
    """The pair plane holds every tile's 2R+1 window columns, which start
    at max(j0 - R, 0) (a slice past its end would silently clamp)."""
    width = fs.search_columns(nx, W, R, nx * W)
    assert width >= nx * W
    for t in range(nx):
        assert max(t * W - R, 0) + 2 * R + 1 <= width, t


def _lowered(platform):
    W, R, rows, cols = 8, 16, 32, 48
    i0, j0, ny, nx = search.tile_origins(rows, cols, W)
    f = jax.jit(lambda g: fs.search_select(
        g, i0, j0, ny, nx, W=W, R=R, T_thresh=1, rows=rows, cols=cols,
        invert=True)[0]["rank"])
    arg = jax.ShapeDtypeStruct((rows, cols), jnp.int8)
    return f.trace(arg).lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_search_lowers_for_platform(platform):
    """The search lowers for the GPU with no card present, as plain XLA:
    no custom call of any kernel."""
    text = _lowered(platform)
    assert "popcnt" in text
    assert "custom_call" not in text


def test_unknown_search_variant_raises(rng):
    grid = _grid(rng, 32, 32, 8, 0.3)
    with pytest.raises(ValueError, match="unknown search variant"):
        _analyze(grid, "mosaic", W=8, R=16, T_thresh=1, rows=32, cols=32)


def test_r_less_than_w_routes_to_host(rng):
    """R < W params produce host-encoder streams (bit-exact round trip);
    encode_analyze refuses them."""
    from binary_image_compression_tpu.models import codec
    img = rng.rand(48, 64) < 0.3
    p = codec.CodecParams(codec=8, W=16, R=8, strict=False)
    blob = compress.encode(img, p)
    assert blob == codec.encode(img, p)
    assert (codec.decode(blob) == img).all()
    blobs = compress.encode_batch(img[None], p)
    assert blobs[0] == blob
    with pytest.raises(ValueError, match="R >= W"):
        compress.encode_analyze(jnp.asarray(img, jnp.int8), W=16, R=8,
                                T_thresh=1, rows=48, cols=64)
