"""Device entropy coding for codec 13: static-table interleaved rANS.

The host codec-13 coder adapts a 16-bit probability per context per bit — a
serial chain with a 2^16-state coder per context that no cheap scan
composition covers (the VERDICT r4 question).  The device variant (payload
mode 2) therefore changes the MODEL, not the math: per-bit adaptation is
replaced by a SEMI-ADAPTIVE two-pass scheme — per-context counts over the
whole page build a quantized static probability table (transmitted once,
~1 KB), and each stripe's bit sequence is coded by N interleaved rANS lanes
(Duda's rANS in the standard 32-bit-state / 16-bit-renorm form with the
ryg-style lane interleave).  The symbol->state update is then a pure vector
op: ONE `lax.scan` over steps = stripe_pixels/N encodes every lane of every
stripe in parallel, there are ZERO gathers inside the scan (per-pixel freqs
are pre-gathered from the 4096-entry table by the device context map), and
the word stream assembles with the parallel-prefix `bitstream.pack_varlen`.
The serial piece that remains is the scan length itself — steps, not
pixels — bounded by the lane count exactly as the stripes bound the host
coder.

Reference referents: GolombCoder.cpp:13-34 / eg.cpp:20-37 are the serial
adaptive coders this de-serializes; in-repo precedent: ops/egdevice.py
(the 32-state EG chain as an associative scan).  Decode is inherently
serial per stripe (contexts come from already-decoded pixels) and stays on
the host: native/bic_native.cpp bic_scab_rans_decode, Python twin in
models/codec._decode_scab_rans.

Coder maths (per symbol, freq f out of 4096, cdf base b):
  encode (reverse order):  if x >= f << 20: emit low 16 bits, x >>= 16
                           x = ((x // f) << 12) + x % f + b
  decode (forward order):  slot = x & 4095; symbol from slot vs cdf
                           x = f * (x >> 12) + slot - b
                           if x < 1 << 16: x = (x << 16) | next_word
State invariant x in [2^16, 2^32); at most one 16-bit emission/pull per
symbol; a padding symbol with f = 4096, b = 0 is an exact no-op (used to
right-pad stripes to a lane multiple — the decoder never touches pads).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .bitstream import pack_varlen

PROB_BITS = 12                      # freqs sum to 4096
PSCALE = 1 << PROB_BITS
CODE_BITS = 6                       # logit-quantized probability codes
N_LANES_DEFAULT = 32

# 64-entry logit-uniform probability table: code q -> P(bit==1) * 4096.
# l_q = -8 + q * 16/63; p = clamp(round(4096 * sigmoid(l_q)), 1, 4095).
# Hard-coded (not recomputed) so the C++ decoder is bit-identical without
# any float contract; mid-range quantization excess is < 0.003 bits/sym.
LOGIT64 = np.asarray([
    1, 2, 2, 3, 4, 5, 6, 8, 10, 13, 17, 22, 29, 37, 48, 61,
    78, 101, 129, 164, 209, 266, 337, 424, 531, 659, 812, 990,
    1193, 1419, 1663, 1918, 2178, 2433, 2677, 2903, 3106, 3284,
    3437, 3565, 3672, 3759, 3830, 3887, 3932, 3967, 3995, 4018,
    4035, 4048, 4059, 4067, 4074, 4079, 4083, 4086, 4088, 4090,
    4091, 4092, 4093, 4094, 4094, 4095], dtype=np.int32)


def quantize_probs(ones, total):
    """Per-context 6-bit probability codes from counts (all [4096] vectors).

    q_c = nearest LOGIT64 code to the Krichevsky-Trofimov estimate
    (ones + 1/2) / (total + 1); float rounding here only affects WHICH code
    is picked (compression), never correctness — the payload carries q."""
    ones = jnp.asarray(ones, jnp.float32)
    total = jnp.asarray(total, jnp.float32)
    p = (ones + 0.5) / (total + 1.0)
    logit = jnp.log(p / (1.0 - p))
    q = jnp.round((jnp.clip(logit, -8.0, 8.0) + 8.0) * (63.0 / 16.0))
    return jnp.clip(q, 0, 63).astype(jnp.int32)


def _cost_bits(ones, zeros, p12):
    """Exact coded bits for (ones, zeros) under a static 12-bit prob."""
    pf = p12.astype(jnp.float32) / PSCALE
    return -(ones * jnp.log2(pf) + zeros * jnp.log2(1.0 - pf))


def build_table(ones, total):
    """(q[4096] int32, transmit[4096] bool, q_default int32, p_used[4096]).

    A context is transmitted iff coding its pixels with its own quantized
    prob saves more than the CODE_BITS it costs to send, vs the page-global
    default prob.  The bitmap is fixed-cost either way, so the rule is
    decoder-transparent: the decoder just reads bitmap + codes."""
    ones = jnp.asarray(ones, jnp.float32)
    total = jnp.asarray(total, jnp.float32)
    zeros = total - ones
    q = quantize_probs(ones, total)
    lut = jnp.asarray(LOGIT64)
    q_def = quantize_probs(ones.sum(), total.sum())
    p_own = lut[q]
    p_def = lut[q_def]
    save = _cost_bits(ones, zeros, p_def) - _cost_bits(ones, zeros, p_own)
    # marginal cost of transmitting: the 6-bit code plus ~6-7 bits of
    # Rice-coded bitmap gap (compress._encode_scab_device picks raw vs
    # Rice-gap bitmap serialization, whichever is smaller)
    transmit = (total > 0) & (save > CODE_BITS + 6.0)
    p_used = jnp.where(transmit, p_own, p_def).astype(jnp.uint32)
    return q, transmit, q_def, p_used


def _onehot64(v):
    """[N] ints in [0, 64) -> [N, 64] bf16 one-hot (0/1 are exact)."""
    return (v[:, None] == jnp.arange(64, dtype=v.dtype)[None, :]).astype(
        jnp.bfloat16)


def count_contexts(ctx_flat, bits_flat, mask=None):
    """ones[4096], total[4096] per-context bit counts.

    The histogram is a contraction instead of a scatter-add: split the 12-bit context into 6-bit halves h/l, then
    count[h, l] = onehot(h)^T @ onehot(l) — two [64, N] x [N, 64]
    contractions.  Products are 0/1 (exact in bf16) and sums < 2^24, with
    f32 accumulation, so the counts are integer-exact."""
    ctx = jnp.asarray(ctx_flat, jnp.int32).ravel()
    bit = jnp.asarray(bits_flat, jnp.int32).ravel()
    if mask is not None:
        m = jnp.asarray(mask, jnp.int32).ravel()
        bit = bit * m
        ctx = jnp.where(m > 0, ctx, 0)
        # masked-off pixels still land in context 0's total; callers that
        # pass a mask must not rely on context 0 (unused today)
    A = _onehot64(ctx >> 6)
    B = _onehot64(ctx & 63)
    f32 = jnp.float32
    total = jax.lax.dot_general(A, B, (((0,), (0,)), ((), ())),
                                preferred_element_type=f32)
    Ab = A * bit.astype(jnp.bfloat16)[:, None]
    ones = jax.lax.dot_general(Ab, B, (((0,), (0,)), ((), ())),
                               preferred_element_type=f32)
    return (ones.reshape(PSCALE).astype(jnp.int32),
            total.reshape(PSCALE).astype(jnp.int32))


def table_lookup(table, ctx):
    """values = table[ctx] for a 4096-entry uint32 table (entries < 4096)
    without a hardware gather: two-level one-hot contraction with the
    table split into 6-bit halves (values <= 63 are exact in bf16; one
    nonzero term per row keeps sums exact in f32)."""
    ctx = jnp.asarray(ctx, jnp.int32).ravel()
    T = jnp.asarray(table, jnp.uint32).reshape(64, 64)
    hi = (T >> 6).astype(jnp.bfloat16)
    lo = (T & 63).astype(jnp.bfloat16)
    A = _onehot64(ctx >> 6)                        # [N, 64]
    L = _onehot64(ctx & 63)
    f32 = jnp.float32
    Mhi = jax.lax.dot_general(A, hi, (((1,), (0,)), ((), ())),
                              preferred_element_type=f32)   # [N, 64]
    Mlo = jax.lax.dot_general(A, lo, (((1,), (0,)), ((), ())),
                              preferred_element_type=f32)
    vhi = (Mhi * L.astype(f32)).sum(axis=1)
    vlo = (Mlo * L.astype(f32)).sum(axis=1)
    return (vhi * 64 + vlo).astype(jnp.uint32)


def rans_encode_scan(f, b, unroll: int = 8):
    """The interleaved-rANS encode scan.

    f, b: uint32 [steps, S, N] per-symbol freq and cdf base in ENCODE
    layout (stripe s, step t, lane l holds pixel t*N + l of stripe s).
    Returns (states uint32 [S, N] — the decoder's INITIAL states,
    words uint32 [steps, S, N], flags bool [steps, S, N]); the stream for
    stripe s is the emitted words in ascending (step, lane) order.

    unroll: symbols per lax.scan step (the scan's serial chain is the cost
    driver — [S, N] per-step vectors are tiny, so per-step overhead
    dominates; unrolling amortizes it U-fold at identical output).  steps
    must divide by unroll (callers pad with the f=4096 no-op symbol)."""
    f = jnp.asarray(f, jnp.uint32)
    b = jnp.asarray(b, jnp.uint32)
    steps = f.shape[0]
    U = unroll if steps % unroll == 0 else 1
    x0 = jnp.full(f.shape[1:], 1 << 16, jnp.uint32)

    def one(x, fs, bs):
        need = (x >> 20) >= fs          # x >= f << 20, shift-safe at f=4096
        w = jnp.where(need, x & 0xFFFF, 0).astype(jnp.uint32)
        x = jnp.where(need, x >> 16, x)
        q = x // fs                     # one div; remainder via mul-sub
        x = (q << PROB_BITS) + (x - q * fs) + bs
        return x, w, need

    if U == 1:
        def step(x, fb):
            x, w, need = one(x, *fb)
            return x, (w, need)

        states, (words, flags) = lax.scan(step, x0, (f, b), reverse=True)
        return states, words, flags

    fu = f.reshape(steps // U, U, *f.shape[1:])
    bu = b.reshape(steps // U, U, *b.shape[1:])

    def stepU(x, fb):
        fs, bs = fb
        ws, needs = [], []
        for u in range(U - 1, -1, -1):  # reverse order within the block
            x, w, need = one(x, fs[u], bs[u])
            ws.append(w)
            needs.append(need)
        return x, (jnp.stack(ws[::-1]), jnp.stack(needs[::-1]))

    states, (words, flags) = lax.scan(stepU, x0, (fu, bu), reverse=True)
    return (states, words.reshape(steps, *f.shape[1:]),
            flags.reshape(steps, *f.shape[1:]))


def pack_stream_words(words, flags, total_words: int):
    """One stripe's emitted u16s -> MSB-first u32 words + bit length.
    words/flags: [L] in stream order."""
    return pack_varlen(words, flags.astype(jnp.uint32) * 16, total_words)


@partial(jax.jit, static_argnames=("n_stripes", "stripe_rows", "n_lanes"))
def rans_page_encode(img_u8, ctx_u16, *, n_stripes: int, stripe_rows: int,
                     n_lanes: int = N_LANES_DEFAULT):
    """The whole mode-2 payload body, on device, one jit.

    img_u8: [rows, cols] 0/1; ctx_u16: the scab_ctx_map output (stripe-top
    aware).  Returns a dict of device arrays; the host only concatenates
    bytes (models/compress.encode_scab backend='device').

      q:          int32 [4096] probability codes
      transmit:   bool  [4096]
      q_default:  int32 []
      states:     uint32 [S, N] decoder initial states
      words:      uint32 [S, Wmax] per-stripe MSB-first streams
      bits:       uint32 [S] per-stripe stream bit counts
      tab_words:  uint32 [768] packed 6-bit codes for transmitted contexts
      tab_bits:   uint32 [] bit count of the code section
    """
    rows, cols = img_u8.shape
    img = jnp.asarray(img_u8, jnp.uint32)
    ctx = jnp.asarray(ctx_u16, jnp.int32)
    ones, total = count_contexts(ctx, img)
    q, transmit, q_def, p_used = build_table(ones, total)

    # per-pixel (f, b): bit==1 -> (p1, f0); bit==0 -> (f0, 0).
    # one-hot lookup, not a hardware gather (table_lookup docstring)
    p1 = table_lookup(p_used, ctx).reshape(ctx.shape)
    f0 = PSCALE - p1
    bit = img
    f_px = jnp.where(bit == 1, p1, f0).astype(jnp.uint32)
    b_px = jnp.where(bit == 1, f0, 0).astype(jnp.uint32)

    # stripe layout [S, Lpad] with exact-no-op pads (f=4096, b=0)
    S = n_stripes
    pad_rows = S * stripe_rows - rows
    L = stripe_rows * cols
    steps = -(-(-(-L // n_lanes)) // 8) * 8   # multiple of the scan unroll
    Lpad = steps * n_lanes

    def to_stripes(a, pad_val):
        a = jnp.pad(a, ((0, pad_rows), (0, 0)), constant_values=pad_val)
        a = a.reshape(S, L)
        a = jnp.pad(a, ((0, 0), (0, Lpad - L)), constant_values=pad_val)
        return a.reshape(S, steps, n_lanes).transpose(1, 0, 2)

    f_s = to_stripes(f_px, PSCALE)
    b_s = to_stripes(b_px, 0)
    states, words, flags = rans_encode_scan(f_s, b_s)

    # stream order: ascending (step, lane) within each stripe
    wv = words.transpose(1, 0, 2).reshape(S, steps * n_lanes)
    fv = flags.transpose(1, 0, 2).reshape(S, steps * n_lanes)
    total_words = -(-steps * n_lanes // 2)      # exact bound: <=16 bits/sym
    sw, sb = jax.vmap(pack_stream_words, in_axes=(0, 0, None))(
        wv, fv, total_words)

    # table section: 6-bit codes of transmitted contexts, ascending ctx
    tab_words, tab_bits = pack_varlen(
        q.astype(jnp.uint32),
        transmit.astype(jnp.uint32) * CODE_BITS,
        -(-PSCALE * CODE_BITS // 32))
    return dict(q=q, transmit=transmit, q_default=q_def, states=states,
                words=sw, bits=sb, tab_words=tab_words, tab_bits=tab_bits,
                n_transmit=transmit.sum())
