"""Device meshes and sharded training/encode steps.

The reference's only parallelism is OpenMP threads (SURVEY.md §2.10); the
device-mesh equivalents built here:

* **data parallelism** — patch rows (BSVD samples) / pages sharded on the
  ``data`` mesh axis: the reference's ``#pragma omp parallel for`` over
  samples (bsvd.cpp:1057) becomes a sharded batch dimension; XLA inserts the
  psum for the change counts.
* **model ("tensor") parallelism** — dictionary atoms sharded on ``model``:
  the [N,K] distance matmul is column-parallel; argmin over K makes XLA
  all-gather along ``model``.
* **spatial parallelism** — image tile-rows sharded on ``data`` with halo
  exchange for causal context (parallel/halo.py), the reference's implicit
  raster "sequence" dimension (SURVEY.md §5 long-context note).
* **bitstream merge** — per-shard codelengths -> exclusive offset scan ->
  gather (parallel/bitmerge.py).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, data: int | None = None,
              model: int | None = None) -> Mesh:
    """2-D (data, model) mesh; defaults to all devices on data with model=1
    unless n_devices is even and >= 4 (then model=2)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if data is None or model is None:
        model = 2 if n % 2 == 0 and n >= 4 else 1
        data = n // model
    arr = np.array(devs).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def shard_bsvd_state(mesh: Mesh, X, E, D, A):
    """Canonical shardings: samples on data, atoms on model."""
    s_rows = NamedSharding(mesh, P("data", None))
    s_atoms = NamedSharding(mesh, P("model", None))
    s_coefs = NamedSharding(mesh, P("data", "model"))
    return (jax.device_put(X, s_rows), jax.device_put(E, s_rows),
            jax.device_put(D, s_atoms), jax.device_put(A, s_coefs))


def sharded_train_step(mesh: Mesh):
    """jit-compiled BSVD alternation step with explicit output shardings.

    GSPMD partitions the [N_shard, K] distance matmul column-wise over
    ``model`` and row-wise over ``data``; the argmin over K and the
    majority-vote counts produce the all-gather / psum collectives
    automatically — the idiomatic pjit formulation (SURVEY.md §7 shard)."""
    from ..models import bsvd

    s_rows = NamedSharding(mesh, P("data", None))
    s_atoms = NamedSharding(mesh, P("model", None))
    s_coefs = NamedSharding(mesh, P("data", "model"))

    @jax.jit
    def step(E, D, A):
        E, D, A = bsvd.learn_train_step(E, D, A)
        E = jax.lax.with_sharding_constraint(E, s_rows)
        D = jax.lax.with_sharding_constraint(D, s_atoms)
        A = jax.lax.with_sharding_constraint(A, s_coefs)
        return E, D, A

    return step


def sharded_encode_analyze(mesh: Mesh, W: int, R: int, T_thresh: int,
                           rows: int, cols: int):
    """Tile-codec analysis with the tile grid sharded by page batch.

    Pages go on ``data`` (embarrassingly parallel); within a page the
    windowed search is already batched over tiles.  Returns a jitted fn
    [B, ny*W, nx*W] -> per-page analysis dicts (stacked); B must divide
    evenly by the ``data`` axis size.

    shard_map (not with_sharding_constraint + vmap): GSPMD cannot propagate
    a partition through the search's per-page band planes, so the constraint
    formulation all-gathered the per-page band planes across the batch
    before slicing each device's page back out — pure interconnect waste on
    a workload with zero cross-page dependence.  Under shard_map each device
    traces its own per-page program and the compiled HLO carries NO
    collectives at all (asserted by tests/test_scaling.py via
    parallel/scaling.py's HLO accounting)."""
    from jax import shard_map

    from ..models import compress

    def body(batch):  # [B/n, rows, cols] local pages
        return jax.vmap(
            lambda im: compress.encode_analyze(
                im, W=W, R=R, T_thresh=T_thresh, rows=rows, cols=cols)
        )(batch)

    out_specs = dict(rank=P("data", None), n_cands=P("data", None),
                     inv=P("data", None), has_cands=P("data", None),
                     weights4=P("data", None, None),
                     idx_len=P("data", None),
                     residual4=P("data", None, None, None))
    return jax.jit(shard_map(body, mesh=mesh,
                             in_specs=P("data", None, None),
                             out_specs=out_specs))
