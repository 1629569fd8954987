"""Halo exchange for spatially-sharded causal prediction.

The MED residual at row r needs row r-1 (pred.cpp:6-14); sharding an image's
rows across devices therefore needs a 1-row halo from the up-neighbor, and
the windowed search needs an R+W-row halo.  Implemented with shard_map +
lax.ppermute over the ``data`` axis — the reference has no analog (its
only parallelism is shared-memory threads, SURVEY.md §2.10)."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import bitpack, predict


def _pad_rows(x, n: int):
    """Zero-pad trailing rows so the row count divides the shard count.

    MED is causal (row r reads only rows <= r), so appended zero rows never
    change the first `rows` rows of either transform."""
    rows = x.shape[-2]
    pad = -rows % n
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
    return x, rows


def med_forward_sharded(mesh: Mesh, packed, cols: int):
    """MED residual of a packed image row-sharded over the 'data' axis.

    Each shard computes locally after receiving its up-neighbor's last row
    via ppermute (the 1-row causal halo).  Ragged row counts are zero-padded
    to the shard multiple and trimmed on return."""
    n = mesh.shape["data"]
    packed, rows = _pad_rows(packed, n)

    @partial(shard_map, mesh=mesh,
             in_specs=P("data", None), out_specs=P("data", None),
             )
    def fn(x):
        # send my LAST row to my down neighbor; receive from up neighbor
        last = x[-1:, :]
        perm = [(i, (i + 1) % n) for i in range(n)]
        halo = lax.ppermute(last, "data", perm)
        idx = lax.axis_index("data")
        halo = jnp.where(idx == 0, jnp.zeros_like(halo), halo)
        # forward MED with the halo row prepended, then drop it
        ext = jnp.concatenate([halo, x], axis=0)
        r = predict.med_forward(ext, cols)
        r = r[1:, :]
        # the first shard's first row must use the true first-row rule;
        # med_forward on ext already did (halo==0 row keeps row-0 semantics
        # only for shard 0; for others the halo carries real context)
        # ... except row 0 of shard 0: ext row0 is zeros, so r[0] came out as
        # the interior formula against a zero halo == the first-row rule.
        return r

    return fn(packed)[:rows]


def med_inverse_sharded(mesh: Mesh, residual, cols: int):
    """Inverse MED across row shards: local prefix-xor scans + a sequential
    carry of each shard's last accumulated row (log-step ppermute scan)."""
    n = mesh.shape["data"]
    residual, rows = _pad_rows(residual, n)

    @partial(shard_map, mesh=mesh,
             in_specs=P("data", None), out_specs=P("data", None),
             )
    def fn(r):
        # local horizontal prefix then local vertical prefix
        x = predict._prefix_xor_bits(r)
        x = lax.associative_scan(jnp.bitwise_xor, x, axis=0)
        # carry: xor of all previous shards' final rows
        last = x[-1:, :]
        carry = jnp.zeros_like(last)
        shift = 1
        while shift < n:
            perm = [(i, i + shift) for i in range(n - shift)]
            inc = lax.ppermute(last, "data", perm)
            idx = lax.axis_index("data")
            inc = jnp.where(idx >= shift, inc, jnp.zeros_like(inc))
            carry = carry ^ inc
            # accumulate pairwise-scanned "last" as in a Hillis-Steele scan
            last = last ^ inc
            shift *= 2
        x = x ^ carry  # broadcast the carry row into every local row
        return x & jnp.asarray(bitpack.trail_mask(cols))

    return fn(residual)[:rows]
