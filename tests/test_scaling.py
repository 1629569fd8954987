"""Counted per-device work and collective traffic (parallel/scaling.py).

The counts come from the compiled sharded HLO on the virtual 8-device CPU
mesh; these tests pin the HLO accounting itself and the collective
structure of each sharded program of the framework.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from binary_image_compression_tpu.parallel import scaling

# small per-device problems keep compiles fast
SHAPES = dict(
    pageshard=dict(rows=128, cols=128, W=16, R=32),
    tileshard=dict(tile_rows_per_dev=2, nx=8, W=16, R=32),
    bsvd=dict(samples_per_dev=256, W=16, K=32),
)


def test_shape_bytes_parser():
    assert scaling._shape_bytes("f32[256,512]{1,0}") == 256 * 512 * 4
    assert scaling._shape_bytes("(s32[64,256]{1,0}, pred[])") == \
        64 * 256 * 4 + 1
    assert scaling._shape_bytes("u8[]") == 1
    assert scaling._shape_bytes("token[]") == 0


def test_collective_traffic_ring_model():
    hlo = """
  %ag = u32[2,8,72,128]{3,2,1,0} all-gather(%x), replica_groups=[1,2]<=[2]
  %ar = (s32[64]{0}, pred[]) all-reduce-start(%a, %b), replica_groups=[1,4]<=[4]
  %ard = s32[64]{0} all-reduce-done(%ar)
  %cp = s8[128,512]{1,0} collective-permute(%y), source_target_pairs={{0,1}}
"""
    t = scaling.collective_traffic(hlo, n_devices=8)
    S_ag = 2 * 8 * 72 * 128 * 4
    assert t["all-gather"] == pytest.approx(S_ag * (2 - 1) / 2)
    S_ar = 64 * 4 + 1
    assert t["all-reduce"] == pytest.approx(2 * S_ar * (4 - 1) / 4)
    assert t["collective-permute"] == 128 * 512
    assert t["count"] == 3  # the -done line must not double count


def test_per_device_flops_counted():
    """cost_analysis counts the partitioned (per-device) module: same
    per-device work at n=1 and n=2 for an embarrassingly parallel map."""
    c1 = scaling.compiled_cost(*scaling.case_pageshard(
        1, **SHAPES["pageshard"]), n_devices=1)
    c2 = scaling.compiled_cost(*scaling.case_pageshard(
        2, **SHAPES["pageshard"]), n_devices=2)
    assert c1.flops > 1e5
    assert abs(c2.flops - c1.flops) / c1.flops < 0.01


def test_pageshard_has_no_collectives():
    """shard_map page parallelism compiles with ZERO collectives (the
    with_sharding_constraint formulation used to all-gather the band
    planes across pages — see mesh.sharded_encode_analyze docstring)."""
    c = scaling.compiled_cost(*scaling.case_pageshard(
        4, **SHAPES["pageshard"]), n_devices=4)
    assert c.collectives["count"] == 0
    assert c.ici_bytes == 0.0


def test_tileshard_halo_bytes_exact():
    """The tileshard halo is exactly ceil(R / block_rows) ppermute hops of
    the int8 [block_rows, gw] block per device."""
    kw = SHAPES["tileshard"]
    n = 4
    c = scaling.compiled_cost(*scaling.case_tileshard(n, **kw), n_devices=n)
    block_rows = kw["tile_rows_per_dev"] * kw["W"]
    gw = kw["nx"] * kw["W"]
    hops = -(-kw["R"] // block_rows)
    assert c.collectives["collective-permute"] == hops * block_rows * gw
    assert c.collectives["count"] == hops


def test_sharded_encode_analyze_matches_single_device():
    """The shard_map page-parallel analyzer is numerically identical to the
    per-page jit (stream-level parity is separately pinned by the tileshard
    and multihost tests)."""
    from binary_image_compression_tpu.models import compress
    from binary_image_compression_tpu.parallel import mesh as pmesh
    rng = np.random.RandomState(7)
    W, R, rows, cols = 8, 16, 32, 32
    n = 4
    m = pmesh.make_mesh(n, data=n, model=1)
    run = pmesh.sharded_encode_analyze(m, W=W, R=R, T_thresh=1,
                                       rows=rows, cols=cols)
    pages = (rng.rand(n, rows, cols) < 0.3).astype(np.int8)
    out = jax.device_get(run(jnp.asarray(pages)))
    for b in range(n):
        ref = jax.device_get(compress.encode_analyze(
            jnp.asarray(pages[b]), W=W, R=R, T_thresh=1,
            rows=rows, cols=cols))
        for k in ref:
            np.testing.assert_array_equal(out[k][b], ref[k], err_msg=k)


def test_crosses_hosts_classifier():
    """DCN split: replica groups spanning a host boundary are flagged,
    purely local ones are not (devices host-major, per_host given)."""
    local = "%ag = u32[8]{0} all-gather(%x), replica_groups={{0,1},{2,3}}"
    cross = "%ag = u32[8]{0} all-gather(%x), replica_groups={{0,2},{1,3}}"
    perm_l = ("%cp = u32[4]{0} collective-permute(%x), "
              "source_target_pairs={{0,1},{1,0}}")
    perm_x = ("%cp = u32[4]{0} collective-permute(%x), "
              "source_target_pairs={{0,2},{2,0}}")
    assert not scaling._crosses_hosts(local, 2)
    assert scaling._crosses_hosts(cross, 2)
    assert not scaling._crosses_hosts(perm_l, 2)
    assert scaling._crosses_hosts(perm_x, 2)
    # per_host = 0 disables the split entirely
    assert not scaling._crosses_hosts(cross, 0)


def test_corpus_merge_gather_crosses_hosts():
    """The corpus encode + offset merge program on a (hosts, data) mesh:
    its only collective is the per-device bit-count gather, which crosses
    hosts once there are two or more of them."""
    costs = {}
    for h in (1, 2, 4):
        fn, args = scaling.case_corpus_merge(2 * h, hosts=h, rows=128,
                                             cols=128, R=32)
        costs[h] = scaling.compiled_cost(fn, args, n_devices=2 * h,
                                         devices_per_host=2)
    assert costs[1].dcn_bytes == 0
    assert costs[2].dcn_bytes > 0
    assert costs[4].dcn_bytes > costs[2].dcn_bytes
    assert all(c.collectives["count"] == 1 for c in costs.values())
