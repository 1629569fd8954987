"""Multi-host pod-slice support (BASELINE.json config #5).

The reference has no distributed anything (SURVEY.md §2.10).  Here:
jax.distributed initialization, a (hosts, devices) mesh layout so
page-level data parallelism spans hosts while tile/atom parallelism stays
within a host, and the corpus encode driver that shards pages by host, encodes each
host's shard with the device mesh, and merges per-host bitstream offsets
(all_gather of per-page byte counts — a [pages] vector — then local
concatenation; no page payload ever crosses hosts twice).

Testable single-host: `make_pod_mesh` degrades to the local mesh, and the
page-shard arithmetic is pure (tests/test_aux.py).  Real 2-process
execution over a CPU coordinator is exercised by
tests/test_multihost_2proc.py.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Bring up jax.distributed for a multi-process run.

    Resolution order: explicit args > BIC_COORDINATOR/BIC_NUM_PROCESSES/
    BIC_PROCESS_ID environment > no-op (single process).  On a real cluster
    slice the runtime usually initializes the coordination service itself
    (process_count() > 1 already) and this returns immediately.  Exercised
    for real by tests/test_multihost_2proc.py (2 CPU processes over a local
    coordinator)."""
    import os
    if coordinator is None:
        coordinator = os.environ.get("BIC_COORDINATOR")
        if coordinator is None:
            return
        num_processes = num_processes or int(
            os.environ["BIC_NUM_PROCESSES"])
        process_id = process_id if process_id is not None else int(
            os.environ["BIC_PROCESS_ID"])
    try:
        jax.distributed.initialize(coordinator, num_processes, process_id)
    except RuntimeError:
        # tolerable only when the runtime already brought the service up
        if jax.process_count() <= 1:
            raise


def make_pod_mesh(model: int = 1) -> Mesh:
    """(hosts, data, model) mesh: hosts maps to the network between hosts, data/model to
    the devices of one host.

    Axis order puts `hosts` outermost so GSPMD keeps cross-host collectives
    on the hosts axis only (page-parallel work never all-gathers across hosts).
    Single-process: hosts axis has size 1 and the mesh is purely local."""
    devs = np.array(jax.devices())
    nproc = jax.process_count()
    per_host = len(devs) // nproc
    data = per_host // model
    arr = devs.reshape(nproc, data, model)
    return Mesh(arr, ("hosts", "data", "model"))


def page_shard_bounds(n_pages: int, n_shards: int, shard: int) -> tuple[int, int]:
    """Contiguous page range for a shard (balanced, deterministic)."""
    base = n_pages // n_shards
    extra = n_pages % n_shards
    start = shard * base + min(shard, extra)
    size = base + (1 if shard < extra else 0)
    return start, start + size


def merge_host_offsets(page_bytes: np.ndarray) -> np.ndarray:
    """Exclusive byte offsets for every page of the corpus given per-page
    byte counts (already all-gathered): the bitstream-merge scan."""
    page_bytes = np.asarray(page_bytes, dtype=np.int64)
    return np.cumsum(page_bytes) - page_bytes


def encode_corpus_sharded(pages, encode_fn=None, mesh: Mesh | None = None,
                          *, params=None, batch_size: int = 8,
                          use_tpu: bool = True) -> list[bytes]:
    """Encode a batch of pages with page-level sharding.

    pages: [B, rows, cols] bool.  Each process encodes its contiguous page
    range THROUGH THE SAME BATCHED ENGINE as the single-host archive path
    (models/archive.encode_pages: vmapped device analysis over same-shaped
    page runs) — pass `params`.  `encode_fn` (a per-page callable) remains
    for codecs without a batched device path.  Returns this host's blobs
    in page order."""
    nproc = jax.process_count()
    pid = jax.process_index()
    lo, hi = page_shard_bounds(len(pages), nproc, pid)
    if encode_fn is not None:
        return [encode_fn(pages[i]) for i in range(lo, hi)]
    from ..models import archive
    return archive.encode_pages([pages[i] for i in range(lo, hi)], params,
                                batch_size=batch_size, use_tpu=use_tpu)
