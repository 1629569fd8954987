"""Device encoder path: byte-identical streams vs the host reference
encoder, and sharded-step correctness on the virtual CPU mesh."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from binary_image_compression_tpu.models import codec, compress, bsvd
from binary_image_compression_tpu.utils import pnm
from binary_image_compression_tpu.ops import bitpack

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("image,W,R", [("text64.pbm", 8, 32),
                                       ("text256.pbm", 16, 64),
                                       ("ragged75x101.pbm", 8, 16),
                                       ("text64.pbm", 4, 8),
                                       ("ragged75x101.pbm", 32, 40)])
def test_tpu_encoder_matches_host(image, W, R):
    img = pnm.read_pbm(os.path.join(FIX, image))
    p = codec.CodecParams(codec=8, W=W, R=R, strict=False)
    host = codec.encode(img, p)
    dev = compress.encode(img, p)
    assert host == dev
    np.testing.assert_array_equal(codec.decode(dev), img)


def test_bsvd_learn_reduces_residual():
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    X = bsvd.patchify_to_rows(img, 8)
    E, D, A, iters = bsvd.learn(X, K=16, init="random_centroids",
                                max_iters=15)
    assert int(E.sum()) < int(X.sum())
    # verification identity |E| == |X ^ A D| (bsvd_test.cpp:153-155)
    np.testing.assert_array_equal(np.asarray(bsvd.residual(X, D, A)),
                                  np.asarray(E))


def test_bsvd_proximus_runs():
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    X = bsvd.patchify_to_rows(img, 8)
    E, D, A, _ = bsvd.learn(X, K=8, dict_update="proximus", max_iters=10)
    np.testing.assert_array_equal(np.asarray(bsvd.residual(X, D, A)),
                                  np.asarray(E))


def test_dryrun_multichip_8cpu():
    import __graft_entry__ as ge
    ge.dryrun_multichip(len(jax.devices()))


def test_sharded_med_matches_single_device():
    from binary_image_compression_tpu.parallel import mesh as pmesh, halo
    from binary_image_compression_tpu.ops import predict
    m = pmesh.make_mesh(len(jax.devices()))
    n = m.shape["data"]
    rows, cols = 8 * n, 96
    img = np.random.RandomState(3).rand(rows, cols) < 0.4
    packed = jnp.asarray(bitpack.np_pack(img))
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharded = jax.device_put(packed, NamedSharding(m, P("data", None)))
    r_sharded = halo.med_forward_sharded(m, sharded, cols)
    r_single = predict.med_forward(packed, cols)
    np.testing.assert_array_equal(np.asarray(r_sharded), np.asarray(r_single))
    back = halo.med_inverse_sharded(m, r_sharded, cols)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(packed))


def test_bitmerge_matches_bitwriter(rng):
    from binary_image_compression_tpu.ops.bitstream import (BitWriter,
                                                            pack_varlen,
                                                            words_to_bytes)
    from binary_image_compression_tpu.parallel.bitmerge import \
        merge_bit_streams
    # three shards of varlen codes merged == one serial BitWriter stream
    shards = []
    w_all = BitWriter()
    for s in range(3):
        lens = rng.randint(1, 33, size=40).astype(np.uint32)
        vals = np.array([rng.randint(0, 1 << min(l, 31)) for l in lens],
                        dtype=np.uint32)
        total = int(lens.sum())
        words, tb = pack_varlen(jnp.asarray(vals), jnp.asarray(lens),
                                (total + 31) // 32)
        shards.append((np.asarray(words), int(tb)))
        for v, l in zip(vals, lens):
            w_all.write_bits(int(v), int(l))
    words, total = merge_bit_streams([w for w, _ in shards],
                                     [b for _, b in shards])
    assert words_to_bytes(words, total) == w_all.getvalue()


@pytest.mark.parametrize("image,W,R", [("text64.pbm", 8, 32),
                                       ("ragged75x101.pbm", 8, 16)])
def test_strict_scan_encoder_matches_host(image, W, R):
    """The lax.scan strict-mode analysis (compress.encode_analyze_strict),
    packed by the native record packer, equals the host strict encoder."""
    from binary_image_compression_tpu import native
    if native.get_lib() is None:
        pytest.skip("no native lib")
    img = pnm.read_pbm(os.path.join(FIX, image))
    p = codec.CodecParams(codec=8, W=W, R=R, strict=True)
    rows, cols = img.shape
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((ny * W, nx * W), np.int8)
    grid[:rows, :cols] = img
    out = jax.device_get(compress.encode_analyze_strict(
        jnp.asarray(grid), W=W, R=R, T_thresh=p.resolved_T(), rows=rows,
        cols=cols))
    M = W * W
    match = out["mode"] < 2
    blob = native.pack_tiles(
        codec._header(p, rows, cols, codec.image_crc(img)), M, out["mode"],
        np.where(match, out["inv"], False), out["rank"].astype(np.int64),
        np.where(match, out["idx_len"], 0), out["weight"],
        bitpack.np_unpack(out["residual"], M).astype(np.uint8))
    assert blob == codec.encode(img, p)


def test_encode_batch_matches_single():
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    pages = np.stack([img, np.roll(img, 3, axis=1), ~img])
    p = codec.CodecParams(codec=8, W=8, R=32, strict=False)
    blobs = compress.encode_batch(pages, p)
    for i in range(3):
        assert blobs[i] == compress.encode(pages[i], p)


@pytest.mark.parametrize("cid", [4, 7])
def test_tpu_encoder_codec47(cid):
    img = pnm.read_pbm(os.path.join(FIX, "text256.pbm"))
    p = codec.CodecParams(codec=cid, W=16, R=64, strict=False)
    assert compress.encode(img, p) == codec.encode(img, p)


def test_tpu_matches_host_doc512():
    """Full-scale byte parity on the bench fixture (W=16, R=128, 1024
    tiles).  Round 1's grouped-conv analysis was silently miscompiled by
    XLA CPU at this scale — streams decoded fine but ran ~30% larger than
    the host encoder's.  The device analysis must match exactly."""
    fix = os.path.join(FIX, "doc512.pbm")
    if not os.path.exists(fix):
        pytest.skip("doc512 fixture not generated")
    img = pnm.read_pbm(fix)
    p = codec.CodecParams(codec=8, W=16, R=128, strict=False)
    dev = compress.encode(img, p)
    assert dev == codec.encode(img, p)
    np.testing.assert_array_equal(codec.decode(dev), img)


def test_encode_batch_vmapped_matches_loop():
    """vmap over the analysis must produce the same streams as the loop
    mode."""
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    pages = np.stack([img, np.roll(img, 3, axis=1), ~img])
    p = codec.CodecParams(codec=8, W=8, R=32, strict=False)
    assert compress.encode_batch(pages, p, vmapped=True) == \
        compress.encode_batch(pages, p, vmapped=False)


def test_device_eg_payload_matches_native(rng):
    """The device-parallel adaptive-EG coder (32-state LUT adaptation as an
    associative scan over transition composition + pack_varlen assembly)
    must be byte-identical to the native serial coder across densities —
    including the reference's anomalous initial state (eg.h ctor g=1/block=1)
    and empty/full planes."""
    import jax.numpy as jnp
    from binary_image_compression_tpu import native
    from binary_image_compression_tpu.models.codec import _med, _medrle_runs
    from binary_image_compression_tpu.ops import egdevice
    from binary_image_compression_tpu.ops.bitstream import words_to_bytes
    if native.get_lib() is None:
        pytest.skip("no native lib")
    for dens, shape in [(0.02, (64, 96)), (0.3, (64, 96)), (0.0, (32, 32)),
                        (1.0, (32, 32)), (0.5, (33, 61)), (0.9, (64, 64))]:
        img = rng.rand(*shape) < dens
        res = _med(img.astype(np.uint8))
        runs = _medrle_runs(img, res)
        n = img.size
        druns, n_runs = egdevice.runs_from_residual_flat(
            jnp.asarray(res.ravel()), n_pixels=n)
        assert int(n_runs) == len(runs)
        np.testing.assert_array_equal(np.asarray(druns[:len(runs)]), runs)
        words, total_bits = egdevice.eg_encode_runs_device(
            druns, n_runs, n_pixels=n)
        assert int(total_bits) <= words.size * 32
        dev = words_to_bytes(np.asarray(words), int(total_bits))
        assert dev == native.eg_encode_runs(runs), (dens, shape)


def test_runs_from_residual_cap_boundaries(rng):
    """The capped run extraction must agree with the uncapped one whenever
    n_runs <= cap, and report the true n_runs (> cap) on overflow so
    callers can fall back — including the exact n_ones == cap boundary."""
    import jax.numpy as jnp
    from binary_image_compression_tpu.ops import egdevice
    n = 64
    for n_ones, trailing in [(0, 0), (3, 1), (7, 0), (8, 0), (8, 1),
                             (9, 0), (20, 1)]:
        flat = np.zeros(n, np.uint8)
        pos = np.sort(rng.choice(n - (1 if trailing else 0),
                                 size=n_ones, replace=False)) \
            if n_ones else np.array([], int)
        if n_ones and not trailing:
            pos[-1] = n - 1          # force no trailing zero run
        flat[pos] = 1
        cap = 8
        full, nr_full = egdevice.runs_from_residual_flat(
            jnp.asarray(flat), n_pixels=n)
        capd, nr_cap = egdevice.runs_from_residual_flat(
            jnp.asarray(flat), n_pixels=n, cap=cap)
        if int(nr_full) <= cap:
            # in-capacity: exact runs AND exact count
            assert int(nr_full) == int(nr_cap)
            np.testing.assert_array_equal(
                np.asarray(full)[:int(nr_full)],
                np.asarray(capd)[:int(nr_cap)])
        else:
            # overflow: the fallback signal must fire (count may differ
            # from the true one — only the first cap ones are probed)
            assert int(nr_cap) > cap


def test_compose_bitplane_matches_gather(rng):
    """The gather-free composition (5 packed state-bit words + lane-wise
    variable shifts) is exactly take_along_axis composition, including on
    non-permutation tables."""
    import jax.numpy as jnp
    from binary_image_compression_tpu.ops import egdevice
    a = jnp.asarray(rng.randint(0, 32, (257, 32)), jnp.uint8)
    b = jnp.asarray(rng.randint(0, 32, (257, 32)), jnp.uint8)
    np.testing.assert_array_equal(
        np.asarray(egdevice._compose(a, b)),
        np.asarray(egdevice._compose_bitplane(a, b)))


def test_planes_device_assembly_matches_native_assembly():
    """encode_planes_device(assembly='device') — the whole codec-10 encode
    as ONE jit shipping bytes through pack_varlen — must equal the native
    per-plane path, which equals the host codec (existing PGM tests)."""
    from binary_image_compression_tpu.utils import bitplanes
    rng2 = np.random.RandomState(9)
    gray = (np.abs(np.cumsum(rng2.randn(64, 96), axis=1)) * 9).astype(
        np.uint32) % 256
    g = gray ^ (gray >> 1)
    planes = bitplanes.decompose(g, 255)
    a = compress.encode_planes_device(planes, assembly="device")
    b = compress.encode_planes_device(planes, assembly="native")
    assert a == b
    for i, blob in enumerate(a):
        np.testing.assert_array_equal(codec.decode(blob), planes[i])


def test_planes_device_assembly_dense_fallback(rng):
    """A residual denser than the device path's run capacity (12.5% ones
    bound) must route to the native coder and stay byte-identical — the
    capped run array would otherwise truncate the payload silently."""
    planes = (rng.rand(2, 32, 32) < 0.5).astype(bool)  # MED residual ~dense
    a = compress.encode_planes_device(planes, assembly="device")
    b = compress.encode_planes_device(planes, assembly="native")
    assert a == b
    for i, blob in enumerate(a):
        np.testing.assert_array_equal(codec.decode(blob), planes[i])


def test_planes_device_assembly_capacity_ladder(rng):
    """Mixed-density stack: sparse planes ride cap level 0 (12.5%), a
    mid-density plane level 1 (25%), an ultra-dense plane goes native —
    each plane individually, with the whole stack byte-identical to the
    native path and the run-count pre-pass routing them exactly."""
    from binary_image_compression_tpu.ops import bitpack as bp
    from binary_image_compression_tpu.ops import predict
    n = 64 * 64
    sparse = rng.rand(64, 64) < 0.01

    def plane_with_residual_density(d):
        # inverse-MED of a d-dense residual => MED forward gives exactly it
        res = jnp.asarray(rng.rand(64, 64) < d)
        back = predict.med_inverse(bp.pack(res), 64)
        return np.asarray(bp.unpack(back, 64)).astype(bool)

    mid = plane_with_residual_density(0.18)      # between 1/8 and 1/4
    dense = plane_with_residual_density(0.40)    # beyond the ladder
    planes = np.stack([sparse, mid, dense, sparse]).astype(bool)
    counts = np.asarray(compress._planes_run_counts(
        jnp.asarray(planes, jnp.uint8), 64))
    # oracle counts from the host run extractor, and the intended routing
    from binary_image_compression_tpu.models.codec import (_med,
                                                           _medrle_runs)
    for i in range(4):
        res = _med(planes[i].astype(np.uint8))
        assert counts[i] == len(_medrle_runs(planes[i], res))
    assert counts[0] <= compress._eg_run_cap(n, 0)            # level 0
    assert compress._eg_run_cap(n, 0) < counts[1] <= \
        compress._eg_run_cap(n, 1)                            # level 1
    assert counts[2] > compress._eg_run_cap(n, 1)             # native
    a = compress.encode_planes_device(planes, assembly="device")
    b = compress.encode_planes_device(planes, assembly="native")
    assert a == b
    for i, blob in enumerate(a):
        np.testing.assert_array_equal(codec.decode(blob), planes[i])


@pytest.mark.parametrize("cid", [4, 7, 8])
def test_decide_modes_kernel_matches_host_replay(rng, cid):
    """The native fused decision + pack (bic_decide_pack, the encoder's
    only decision path) must replay the two adaptive Golomb contexts
    bit-identically to the Python replay (compress._decide_modes) —
    including k transitions, ties, and no-candidate tiles."""
    from binary_image_compression_tpu import native
    if native.get_lib() is None:
        pytest.skip("no native lib")
    W, T = 8, 300
    M = W * W
    out = dict(weights4=rng.randint(0, M + 1, size=(T, 4)).astype(np.int32),
               has_cands=rng.rand(T) < 0.8,
               idx_len=rng.randint(1, 12, size=T).astype(np.int32),
               inv=rng.rand(T) < 0.5,
               rank=rng.randint(0, 2, size=T).astype(np.int32),
               residual4=rng.randint(0, 2 ** 32, size=(T, 4, M // 32),
                                     dtype=np.uint64).astype(np.uint32))
    # residual weights must match the residual words they describe
    bits = bitpack.np_unpack(out["residual4"], M)
    out["weights4"] = bits.sum(axis=-1).astype(np.int32)
    out["rank"] = np.minimum(out["rank"], (1 << out["idx_len"]) - 1)
    hdr = codec._header(codec.CodecParams(codec=cid, W=W, R=16), 8, 8, 0)
    assert compress._assemble(out, hdr, M, T, cid) == \
        compress._assemble_python(out, hdr, M, T, cid)


def test_encode_pgm_device_assembly_backend():
    """encode_pgm(backend='tpu-device-assembly') routes the payload through
    the on-device EG + pack_varlen assembly and stays byte-identical."""
    rng = np.random.RandomState(3)
    gray = (np.cumsum(rng.rand(48, 64) < 0.2, axis=1) * 11 % 64).astype(
        np.uint32)
    a = codec.encode_pgm(gray, 63, backend="tpu-device-assembly")
    b = codec.encode_pgm(gray, 63, backend="tpu")
    assert a == b
    g2, mv = codec.decode_pgm(a)
    assert mv == 63
    np.testing.assert_array_equal(g2, gray)
