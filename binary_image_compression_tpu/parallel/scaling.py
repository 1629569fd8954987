"""Per-device work and collective traffic counted in compiled sharded HLO.

XLA compiles the same SPMD module for a virtual CPU mesh
(--xla_force_host_platform_device_count) as it would run per device, so
without any accelerator

  * ``compiled.cost_analysis()`` counts the PER-DEVICE flops / bytes of the
    partitioned module (doubling the mesh with the per-device problem fixed
    keeps the counts constant), and
  * the optimized HLO text names every collective with its shape and
    replica groups, from which per-device traffic follows from the
    standard ring-algorithm byte counts.

These are counts of what each sharded program moves and computes, not
times: how long a device takes for them is measured on the device.

Caveat: flops inside lax.while bodies are counted once per body (XLA's
static HLO cost model).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import jax
import jax.numpy as jnp

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}
_SHAPE_RE = re.compile(
    r"\b(pred|s8|u8|s16|u16|bf16|f16|s32|u32|f32|s64|u64|f64)\[([0-9,]*)\]")
_COLL_RE = re.compile(
    r"=\s*(.*?)\s(all-reduce|all-gather|reduce-scatter|collective-permute"
    r"|all-to-all)(-start)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")


def _shape_bytes(text: str) -> int:
    """Total bytes of every dtype[dims] shape token in `text`."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


_GROUPS_ALL_RE = re.compile(r"replica_groups=\{((?:\{[0-9,]+\},?)+)\}")
_SRCTGT_RE = re.compile(r"source_target_pairs=\{((?:\{\d+,\d+\},?)+)\}")


def _groups_members(line: str):
    """Full replica-group member lists from an HLO collective line, or
    None when only the [n,g] iota form is present."""
    gb = _GROUPS_ALL_RE.search(line)
    if not gb:
        return None
    return [[int(x) for x in grp.split(",") if x]
            for grp in gb.group(1).strip("{}").split("},{")]


def _crosses_hosts(line: str, devices_per_host: int) -> bool:
    """Whether any replica group (or permute pair) spans a host boundary,
    with devices numbered host-major (device d lives on d // per_host)."""
    if devices_per_host <= 0:
        return False
    sp = _SRCTGT_RE.search(line)
    if sp:
        for pair in sp.group(1).strip("{}").split("},{"):
            a, b = (int(x) for x in pair.split(","))
            if a // devices_per_host != b // devices_per_host:
                return True
        return False
    groups = _groups_members(line)
    if groups is None:
        return True  # iota form over all devices: conservatively cross-host
    for grp in groups:
        hosts = {m // devices_per_host for m in grp}
        if len(hosts) > 1:
            return True
    return False


def collective_traffic(hlo_text: str, n_devices: int,
                       devices_per_host: int = 0) -> dict:
    """Per-device collective bytes by kind, ring-algorithm model.

    devices_per_host > 0 splits off the host-spanning collectives: one whose
    replica group spans hosts crosses the network between hosts, so its
    ring bytes land in ``dcn_total`` instead of the per-kind totals.

    For result bytes S and replica-group size g:
      all-gather       S (gathered shape) -> each device moves S*(g-1)/g
      all-reduce       S                  -> 2*S*(g-1)/g (reduce-scatter+ag)
      reduce-scatter   S (scattered out)  -> input S*g, moves S*(g-1)
      collective-permute S                -> S (one send per device)
      all-to-all       S                  -> S*(g-1)/g
    """
    out = {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0,
           "collective-permute": 0.0, "all-to-all": 0.0, "count": 0,
           "dcn_total": 0.0}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m or f"{m.group(2)}-done(" in line:
            continue
        S = _shape_bytes(m.group(1))
        gm = _GROUPS_RE.search(line)
        if gm:
            g = int(gm.group(2))
        else:
            gb = _GROUPS_BRACE_RE.search(line)
            g = len(gb.group(1).split(",")) if gb else n_devices
        g = max(g, 1)
        kind = m.group(2)
        if kind == "all-gather":
            moved = S * (g - 1) / g
        elif kind == "all-reduce":
            moved = 2.0 * S * (g - 1) / g
        elif kind == "reduce-scatter":
            moved = S * (g - 1)
        elif kind == "collective-permute":
            moved = float(S)
        else:  # all-to-all
            moved = S * (g - 1) / g
        if devices_per_host and _crosses_hosts(line, devices_per_host):
            out["dcn_total"] += moved
        else:
            out[kind] += moved
        out["count"] += 1
    out["total"] = sum(out[k] for k in
                       ("all-reduce", "all-gather", "reduce-scatter",
                        "collective-permute", "all-to-all"))
    return out


@dataclass
class DevCost:
    """Per-device counted cost of one compiled sharded program."""
    n_devices: int
    flops: float
    bytes_accessed: float
    ici_bytes: float
    collectives: dict
    dcn_bytes: float = 0.0


def compiled_cost(jitted, args, n_devices: int,
                  devices_per_host: int = 0) -> DevCost:
    """Lower + compile a jitted fn and count its per-device work + comm."""
    comp = jitted.lower(*args).compile()
    ca = comp.cost_analysis()
    if isinstance(ca, list):  # older jax returns [dict]
        ca = ca[0]
    coll = collective_traffic(comp.as_text(), n_devices, devices_per_host)
    return DevCost(n_devices=n_devices, flops=float(ca.get("flops", 0.0)),
                   bytes_accessed=float(ca.get("bytes accessed", 0.0)),
                   ici_bytes=float(coll["total"]), collectives=coll,
                   dcn_bytes=float(coll["dcn_total"]))


# ---------------------------------------------------------------------------
# the three sharded programs of the framework, weak-scaling cases
# (per-device problem size FIXED as n grows)
# ---------------------------------------------------------------------------

def case_pageshard(n: int, *, rows: int = 512, cols: int = 512, W: int = 16,
                   R: int = 128):
    """One page per device through the full encoder analysis."""
    from . import mesh as pmesh
    m = pmesh.make_mesh(n, data=n, model=1)
    run = pmesh.sharded_encode_analyze(m, W=W, R=R, T_thresh=2,
                                       rows=rows, cols=cols)
    pages = jax.ShapeDtypeStruct((n, rows, cols), jnp.int8)
    return run, (pages,)


def case_tileshard(n: int, *, tile_rows_per_dev: int = 8, nx: int = 32,
                   W: int = 16, R: int = 128):
    """One image, its tile rows sharded with multi-hop ppermute halo."""
    from . import mesh as pmesh
    from . import tileshard
    m = pmesh.make_mesh(n, data=n, model=1)
    block_rows = tile_rows_per_dev * W
    gh, gw = n * block_rows, nx * W
    fn = tileshard._sharded_fn(m, n, W, R, 2, gh, gw, gw, block_rows, True)
    return fn, (jax.ShapeDtypeStruct((gh, gw), jnp.int8),)


def case_bsvd(n: int, *, samples_per_dev: int = 1024, W: int = 16,
              K: int = 64):
    """BSVD train step, samples on data (the OMP loop of bsvd.cpp:1057)."""
    from . import mesh as pmesh
    m = pmesh.make_mesh(n, data=n, model=1)
    step = pmesh.sharded_train_step(m)
    M = W * W
    N = n * samples_per_dev
    E = jax.ShapeDtypeStruct((N, M), jnp.int8)
    D = jax.ShapeDtypeStruct((K, M), jnp.int8)
    A = jax.ShapeDtypeStruct((N, K), jnp.int8)
    return step, (E, D, A)


def case_corpus_merge(n: int, *, hosts: int = 1, rows: int = 512,
                      cols: int = 512, W: int = 16, R: int = 128):
    """Page-sharded corpus encode + device bit-offset merge on a
    (hosts, data) mesh — the multi-host BASELINE config (#5) as a compiled
    program.

    One page per device (weak scaling over hosts, data width fixed); the
    only cross-device dependence is the exclusive bitstream-offset scan
    (parallel/bitmerge.exclusive_offsets): an all_gather of per-device bit
    counts over BOTH axes, whose replica group spans hosts — exactly the
    [pages]-vector cross-host gather the real driver does
    (multihost.encode_corpus_sharded + merge_host_offsets)."""
    import numpy as _np
    from jax import shard_map
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P
    from ..models import compress
    data = n // hosts
    devs = _np.array(jax.devices()[:n]).reshape(hosts, data)
    m = Mesh(devs, ("hosts", "data"))

    def body(batch):        # [1, rows, cols] local page
        o = jax.vmap(lambda im: compress.encode_analyze(
            im, W=W, R=R, T_thresh=2, rows=rows, cols=cols))(batch)
        # per-device payload bits (residual weight total is proportional to
        # the enumerative payload; the collective structure is what the
        # model counts)
        nbits = o["weights4"].min(axis=-1).sum().astype(jnp.uint32)
        allc = lax.all_gather(nbits, ("hosts", "data"))  # crosses hosts
        idx = (lax.axis_index("hosts") * data + lax.axis_index("data"))
        off = (allc * (jnp.arange(n) < idx)).sum(dtype=jnp.uint32)
        return off[None], o["rank"], o["weights4"]

    fn = jax.jit(shard_map(
        body, mesh=m, in_specs=P(("hosts", "data"), None, None),
        out_specs=(P(("hosts", "data")), P(("hosts", "data"), None),
                   P(("hosts", "data"), None, None))))
    pages = jax.ShapeDtypeStruct((n, rows, cols), jnp.int8)
    return fn, (pages,)


CASES = {"pageshard": case_pageshard, "tileshard": case_tileshard,
         "bsvd": case_bsvd}
