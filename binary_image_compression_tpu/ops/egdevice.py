"""Device-parallel adaptive exponential-Golomb run coding (codec 10).

The reference's EG coder (eg.cpp:20-37) is a serial state machine: each run
emits one '1' per full block (growing the 32-entry LUT state) then '0' plus
a g-bit remainder (shrinking it), so the block size entering run i depends
on every previous run.  That chain looks hopelessly serial — but the state
space is just the 32 LUT indices, so each run induces a map
f_i : state -> state, and the entry states of ALL runs are an
`associative_scan` over map composition (a monoid on [32]-tables).  With
entry states known, every run's bit pattern is independent and the payload
assembles with the parallel-prefix scatter `bitstream.pack_varlen`.

This makes the WHOLE codec-10 payload a single jittable program:
  residual plane -> run lengths (nonzero-gap scan) -> per-run transition
  tables -> associative scan -> per-run (nb, g, rem) -> <=32-bit code
  chunks -> pack_varlen -> uint32 words.

Byte-identical to the host/native coder (native/bic_native.cpp EGState;
tests/test_compress_tpu.py::test_device_eg_payload_matches_native).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .bitstream import pack_varlen
from .entropy import EGLUT

_LUT = np.asarray(EGLUT, dtype=np.int32)          # g per state, max 15
_BLOCKS = (1 << _LUT).astype(np.int64)            # block size per state


@lru_cache(maxsize=8)
def _geometry(n_pixels: int):
    """(J_max, K_codes) — static bounds for runs up to n_pixels.

    J_max: most '1' prefix bits any run can emit (worst case: entry state 0,
    blocks grow along the LUT then saturate at 2^15).  K_codes: uint32
    chunks per run code (cl <= J_max + 1 + 15)."""
    assert n_pixels < 2 ** 30, "int32 run arithmetic"
    acc, j = 0, 0
    while acc < n_pixels:
        acc += int(_BLOCKS[min(j, 31)])
        j += 1
    jmax = j
    return jmax, -(-(jmax + 16) // 32)


def _run_transitions(runs, n_pixels: int):
    """exit[i, s]: LUT state after coding run i entered at state s.

    Iterative block consumption on [N, 32] arrays (J_max steps, elementwise
    — no [N, 32, J] materialization).  Also returns nb[i, s] (count of '1'
    prefix bits), from which g and the remainder follow."""
    jmax, _ = _geometry(n_pixels)
    N = runs.shape[0]
    s0 = jnp.arange(32, dtype=jnp.int32)[None, :]          # entry states
    blocks = jnp.asarray(_BLOCKS, jnp.int32)

    def step(t, carry):
        rem, nb = carry
        cur = jnp.minimum(s0 + t, 31)
        blk = blocks[cur]
        take = rem >= blk
        rem = rem - jnp.where(take, blk, 0)
        nb = nb + take.astype(jnp.int32)
        return rem, nb

    rem0 = jnp.broadcast_to(runs[:, None].astype(jnp.int32), (N, 32))
    rem, nb = lax.fori_loop(0, jmax, step, (rem0, jnp.zeros((N, 32),
                                                            jnp.int32)))
    # terminator: state at the '0' bit is min(s0+nb, 31); decBlockSize after
    s_term = jnp.minimum(s0 + nb, 31)
    exit_s = jnp.maximum(s_term - 1, 0)
    return exit_s.astype(jnp.uint8), nb, rem, s_term


def _compose(a, b):
    """(a then b) on [..., 32] state tables: out[s] = b[a[s]]."""
    return jnp.take_along_axis(b, a.astype(jnp.int32), axis=-1).astype(
        jnp.uint8)


def _compose_bitplane(a, b):
    """Gather-free _compose: tables are 32 entries of 5-bit states, so each
    of b's 5 state bits packs into ONE uint32 word (bit s = bit of b[s]) and
    b[a[s]] becomes a lane-wise variable shift — elementwise ops only, no
    take_along_axis."""
    s_iota = jnp.arange(32, dtype=jnp.uint32)
    av = a.astype(jnp.uint32)
    bv = b.astype(jnp.uint32)
    out = jnp.zeros_like(av)
    for bit in range(5):
        plane = (((bv >> bit) & 1) << s_iota).sum(axis=-1,
                                                  dtype=jnp.uint32)
        out = out | (((plane[..., None] >> av) & 1) << bit)
    return out.astype(jnp.uint8)


@partial(jax.jit, static_argnames=("n_pixels",))
def eg_encode_runs_device(runs, n_runs, *, n_pixels: int):
    """Adaptive-EG payload for a padded run array, fully on device.

    runs: int32 [N_max] zero-run lengths (entries >= n_runs ignored);
    n_runs: dynamic count.  Returns (words uint32[n_pixels//32 + 2],
    total_bits) — `bitstream.words_to_bytes` serializes byte-identically to
    the native EGState coder."""
    jmax, K = _geometry(n_pixels)
    N = runs.shape[0]
    runs = jnp.asarray(runs, jnp.int32)
    live = jnp.arange(N) < n_runs

    # Reference quirk (eg.h ctor): the coder STARTS with g=1, block=1 —
    # off the LUT (state 0 has g=0).  Only the first run sees it: if
    # runs[0] >= 1 the first block consumes ONE pixel and lands on state 1,
    # after which everything is table-consistent; if runs[0] == 0 the
    # terminator writes '0' + a 1-bit remainder and stays at state 0.
    # Model it by coding run 0 as (1 prefix bit) + normal coding of
    # runs[0]-1 from entry state 1.
    L0 = runs[0]
    runs_adj = runs.at[0].set(jnp.maximum(L0 - 1, 0))
    exit_s, nb_all, rem_all, s_term_all = _run_transitions(runs_adj,
                                                           n_pixels)
    # padded tail: identity transitions (they sit after every live run)
    ident = jnp.broadcast_to(jnp.arange(32, dtype=jnp.uint8)[None, :],
                             exit_s.shape)
    exit_s = jnp.where(live[:, None], exit_s, ident)
    # run 0's true exit (uniform row: only [.., 0] feeds the scan)
    exit0 = jnp.where(L0 >= 1, exit_s[0, 1].astype(jnp.int32),
                      jnp.int32(0)).astype(jnp.uint8)
    exit_s = exit_s.at[0].set(jnp.broadcast_to(exit0, (32,)))
    # entry state of run i = composition of transitions 0..i-1 from state 0.
    # _compose_bitplane, not the take_along_axis _compose: the scan's
    # log2(N) composition levels stay elementwise
    chain = lax.associative_scan(_compose_bitplane, exit_s, axis=0)
    entry = jnp.concatenate([jnp.ones((1,), jnp.uint8),  # run 0: state 1
                             chain[:-1, 0]]).astype(jnp.int32)

    pick = lambda tab: jnp.take_along_axis(tab, entry[:, None],
                                           axis=1)[:, 0]
    nb = pick(nb_all)
    rem = pick(rem_all)
    g = jnp.asarray(_LUT, jnp.int32)[pick(s_term_all)]
    # splice run 0's special form in
    nb = nb.at[0].set(jnp.where(L0 >= 1, nb[0] + 1, 0))
    g = g.at[0].set(jnp.where(L0 >= 1, g[0], 1))
    rem = rem.at[0].set(jnp.where(L0 >= 1, rem[0], 0))
    cl = jnp.where(live, nb + 1 + g, 0)

    # pattern per run: nb ones, '0', g-bit remainder — split MSB-first into
    # K uint32 chunks (positions [32c, 32c + len_c))
    c = jnp.arange(K, dtype=jnp.int32)[None, :]
    len_c = jnp.clip(cl[:, None] - 32 * c, 0, 32)
    ones_c = jnp.clip(nb[:, None] - 32 * c, 0, len_c)
    # terminator+remainder field F = rem as a (g+1)-bit value (top bit 0)
    tail_len = len_c - ones_c
    # offset of the chunk's tail inside F
    toff = jnp.clip(32 * c + ones_c - nb[:, None], 0, 31)
    fwidth = (g + 1)[:, None]
    shift = jnp.clip(fwidth - toff - tail_len, 0, 31)
    tmask = jnp.where(tail_len >= 32, jnp.uint32(0xFFFFFFFF),
                      (jnp.uint32(1) << jnp.minimum(tail_len, 31)
                       .astype(jnp.uint32)) - 1)
    tail = (rem[:, None].astype(jnp.uint32)
            >> shift.astype(jnp.uint32)) & tmask
    ones_val = jnp.where(
        ones_c >= 32, jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << jnp.minimum(ones_c, 31).astype(jnp.uint32)) - 1)
    value = (ones_val << jnp.minimum(tail_len, 31).astype(jnp.uint32)) | tail

    # payload bound: dense residuals EXPAND under EG (every run pays the
    # '0'+g terminator), so 1 bit/pixel is not safe; terminator costs
    # amortize against block consumption, bounding pathological input well
    # under 4 bits/pixel.  Callers must check total_bits <= 32*total_words
    # (pack_varlen drops out-of-range codes silently).
    total_words = n_pixels // 8 + 8
    words, total_bits = pack_varlen(value.reshape(-1),
                                    len_c.reshape(-1).astype(jnp.uint32),
                                    total_words)
    return words, total_bits


@partial(jax.jit, static_argnames=("n_pixels", "cap"))
def runs_from_residual_flat(flat_bits, *, n_pixels: int,
                            cap: int | None = None):
    """Zero-run lengths of a flat 0/1 residual, on device (codec-10 symbol
    stream, models/codec._medrle_runs semantics: gaps before each 1 plus
    the trailing zero run when nonempty).

    cap bounds the returned run array ([cap] instead of [n_pixels + 1]):
    the nonzero gather and everything downstream then scale with cap, not
    the pixel count.  Contract: whenever the true run count fits cap,
    (runs, n_runs) are exact; when it does not, n_runs is still
    guaranteed > cap (it may differ from the true count — the trailing
    probe only sees the first cap ones), which is the only property
    callers use to fall back (models/compress.encode_planes_device).

    Returns (runs int32 [cap or n_pixels + 1], n_runs)."""
    size = n_pixels + 1 if cap is None else cap
    flat = jnp.asarray(flat_bits, jnp.int32).reshape(n_pixels)
    n_ones = flat.sum()
    idx = jnp.nonzero(flat, size=size, fill_value=n_pixels)[0]
    prev = jnp.concatenate([jnp.full((1,), -1, idx.dtype), idx[:-1]])
    gaps = (idx - prev - 1).astype(jnp.int32)
    # mask the fill tail so the trailing-run scatter below is the only
    # nonzero entry past the gaps
    live = jnp.arange(size) < n_ones
    gaps = jnp.where(live, gaps, 0)
    last_one = jnp.where(n_ones > 0, idx[jnp.minimum(
        jnp.maximum(n_ones - 1, 0), size - 1)], -1)
    trailing = n_pixels - 1 - last_one
    # trailing zero run (decoder stops on pixel count, so only if nonempty);
    # out-of-range scatter (n_ones >= size) drops, callers detect overflow
    # via n_runs
    runs = gaps.at[n_ones].set(trailing.astype(jnp.int32),
                               mode="drop")
    n_runs = n_ones + (trailing > 0).astype(n_ones.dtype)
    return runs, n_runs
