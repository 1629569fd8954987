"""Real 2-process jax.distributed run (BASELINE config #5, scaled to CPU).

Two subprocesses join a local coordinator, build the (hosts, data, model)
pod mesh, shard a page corpus by host, encode their shards, all-gather the
per-page byte counts across processes, and agree on the merged bitstream
offsets — the multi-host corpus-encode control flow end to end
(parallel/multihost.py), minus a real multi-host network.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

sys.path.insert(0, os.environ["BIC_REPO"])
from binary_image_compression_tpu.parallel import multihost
from binary_image_compression_tpu.models import codec

pid = int(os.environ["BIC_PROCESS_ID"])
multihost.init_distributed()
assert jax.process_count() == 2, jax.process_count()
assert jax.process_index() == pid

mesh = multihost.make_pod_mesh(model=1)
assert mesh.shape["hosts"] == 2, dict(mesh.shape)
assert mesh.shape["data"] == 2

rng = np.random.RandomState(0)
pages = (rng.rand(6, 32, 32) < 0.3)            # identical corpus everywhere
lo, hi = multihost.page_shard_bounds(len(pages), jax.process_count(), pid)
# the host shard rides the SAME batched device engine as the single-host
# archive path (archive.encode_pages); per-page byte parity vs the host
# reference encoder proves the unification didn't change streams
p8 = codec.CodecParams(codec=8, W=8, R=16, strict=False)
blobs = multihost.encode_corpus_sharded(pages, params=p8, batch_size=2)
assert len(blobs) == hi - lo
for k in range(hi - lo):
    assert blobs[k] == codec.encode(pages[lo + k], p8), ("page", lo + k)

counts_local = np.zeros(len(pages), dtype=np.int64)
counts_local[lo:hi] = [len(b) for b in blobs]
from jax.experimental import multihost_utils
gathered = multihost_utils.process_allgather(counts_local)
counts = np.asarray(gathered).sum(axis=0)       # shards are disjoint
assert (counts > 0).all(), counts
offsets = multihost.merge_host_offsets(counts)
# every process decodes a page from the OTHER host's shard for consistency
other = (lo + len(pages) // 2) % len(pages)
print("RESULT", pid, ",".join(map(str, counts.tolist())),
      ",".join(map(str, offsets.tolist())))

# ---- sharded COMPUTE across processes (hosts axis used for real work) ----
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from binary_image_compression_tpu.models import bsvd
from binary_image_compression_tpu.parallel import halo
from binary_image_compression_tpu.ops import bitpack, predict
from jax.sharding import Mesh

# (a) one BSVD train step with samples sharded over (hosts, data) — 4
# global devices, 2 per process; cross-host collectives ride the hosts axis
N, K, M = 16, 8, 64
X = (rng.rand(N, M) < 0.4).astype(np.int8)
D0 = (rng.rand(K, M) < 0.3).astype(np.int8)
A0 = (rng.rand(N, K) < 0.2).astype(np.int8)
E0 = (X ^ (A0 @ D0) % 2).astype(np.int8)
s_rows = NamedSharding(mesh, P(("hosts", "data"), None))
rep = NamedSharding(mesh, P())

@jax.jit
def step(E, D, A):
    E, D, A = bsvd.learn_train_step(E, D, A)
    return (jax.lax.with_sharding_constraint(E, s_rows),
            jax.lax.with_sharding_constraint(D, rep),
            jax.lax.with_sharding_constraint(A, s_rows))

Eg = jax.device_put(jnp.asarray(E0), s_rows)
Dg = jax.device_put(jnp.asarray(D0), rep)
Ag = jax.device_put(jnp.asarray(A0), s_rows)
E1, D1, A1 = step(Eg, Dg, Ag)
sums = jax.jit(lambda e, d, a: (e.sum(), d.sum(), a.sum()),
               out_shardings=(rep, rep, rep))(E1, D1, A1)
got = [int(x) for x in jax.device_get(sums)]
# single-device reference (pure function of the same inputs)
Er, Dr, Ar = jax.jit(bsvd.learn_train_step)(
    jnp.asarray(E0), jnp.asarray(D0), jnp.asarray(A0))
want = [int(Er.sum()), int(Dr.sum()), int(Ar.sum())]
assert got == want, (got, want)
print("TRAIN", pid, ",".join(map(str, got)))

# (b) halo MED forward + inverse over a flat 4-device cross-process mesh
flat = Mesh(np.array(jax.devices()), ("data",))
img = (rng.rand(32, 64) < 0.35)
packed = np.asarray(bitpack.np_pack(img.astype(np.uint8)))

def wordsum(a):  # int32-safe checksum of uint32 words (no x64)
    return ((a & 0xFFFF).astype(jnp.int32).sum()
            + (a >> 16).astype(jnp.int32).sum())

res = halo.med_forward_sharded(flat, jnp.asarray(packed), 64)
back = halo.med_inverse_sharded(flat, res, 64)
rep_f = NamedSharding(flat, P())
ok_inv, csum = jax.device_get(jax.jit(
    lambda b, r: ((b == jnp.asarray(packed)).all(), wordsum(r)),
    out_shardings=(rep_f, rep_f))(back, res))
assert bool(ok_inv)
r_ref = np.asarray(predict.med_forward(jnp.asarray(packed), 64))
csum_ref = int((r_ref & 0xFFFF).sum() + (r_ref >> 16).sum())
assert int(csum) == csum_ref, (int(csum), csum_ref)
print("HALO", pid, int(csum), int(bool(ok_inv)))
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_corpus_encode(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"   # a child never touches the card
        env.update(BIC_REPO=REPO,
                   BIC_COORDINATOR=f"127.0.0.1:{port}",
                   BIC_NUM_PROCESSES="2", BIC_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append({l.split()[0]: l.split()[2:] for l in out.splitlines()
                     if l.split() and l.split()[0] in ("RESULT", "TRAIN",
                                                       "HALO")})
    # both processes agree on: corpus counts/offsets, the sharded BSVD
    # train-step state sums, and the cross-process halo MED checksum
    for key in ("RESULT", "TRAIN", "HALO"):
        assert key in outs[0] and key in outs[1], (key, outs)
        assert outs[0][key] == outs[1][key], (key, outs)
