"""Real bitstream assembly — the capability the reference never finished.

The reference's entropy "coders" only count bits (GolombCoder.cpp:26); both
its decoders are dead code (GolombDecoder.h:13 includes a file that does not
exist; eg.cpp:39-56 is #if 0).  This module supplies:

* ``BitWriter`` / ``BitReader`` — MSB-first host-side bit IO (numpy-backed).
* Golomb-Rice encode/decode matching the reference's length arithmetic
  (binary part of k bits MSB-first, then `u >> k` zeros, then a 1 terminator —
  the layout sketched in GolombCoder.cpp:21-25's comments).
* Exact enumerative coding of a fixed-weight bit pattern via the
  combinatorial number system: a weight-w pattern over n positions is coded
  as its lexicographic rank in ceil(log2 C(n, w)) bits — the integer-bit
  realisation of the reference's enumL estimate (compress8_test.cpp:25-28).
* ``pack_varlen`` — the device-parallel path: per-symbol (value, length) pairs
  -> exclusive prefix-sum of bit offsets -> scatter into uint32 lanes; this
  is the parallel-prefix bitstream assembly named in BASELINE.json.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


class BitWriter:
    """MSB-first bit accumulator producing bytes."""

    def __init__(self):
        self._acc = 0
        self._nacc = 0
        self._out = bytearray()

    def write_bits(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self._acc = (self._acc << nbits) | value
        self._nacc += nbits
        while self._nacc >= 8:
            self._nacc -= 8
            self._out.append((self._acc >> self._nacc) & 0xFF)
        self._acc &= (1 << self._nacc) - 1

    def write_unary_zeros(self, n: int) -> None:
        while n >= 32:
            self.write_bits(0, 32)
            n -= 32
        self.write_bits(0, n)

    @property
    def bitcount(self) -> int:
        return len(self._out) * 8 + self._nacc

    def getvalue(self) -> bytes:
        if self._nacc:
            pad = 8 - self._nacc
            return bytes(self._out) + bytes([(self._acc << pad) & 0xFF])
        return bytes(self._out)


class BitReader:
    """MSB-first bit reader over bytes."""

    def __init__(self, data: bytes, bit_offset: int = 0):
        self._data = data
        self._pos = bit_offset

    def read_bits(self, nbits: int) -> int:
        v = 0
        p = self._pos
        for _ in range(nbits):
            byte = self._data[p >> 3]
            v = (v << 1) | ((byte >> (7 - (p & 7))) & 1)
            p += 1
        self._pos = p
        return v

    def read_unary_zeros(self) -> int:
        """Count zeros until (and consuming) the terminating 1 bit."""
        n = 0
        while self.read_bits(1) == 0:
            n += 1
        return n

    @property
    def bit_position(self) -> int:
        return self._pos


# ---------------------------------------------------------------------------
# Golomb-Rice with the reference's adaptive k (real code, decodable)
# ---------------------------------------------------------------------------

def golomb_encode(w: BitWriter, u: int, k: int) -> None:
    """binary low-k bits, then (u >> k) zeros, then 1 (GolombCoder.cpp:21-25)."""
    w.write_bits(u, k)
    w.write_unary_zeros(u >> k)
    w.write_bits(1, 1)


def golomb_decode(r: BitReader, k: int) -> int:
    low = r.read_bits(k)
    high = r.read_unary_zeros()
    return (high << k) | low


# ---------------------------------------------------------------------------
# Exact enumerative (combinatorial number system) coding
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _binom_table(n: int):
    """Pascal triangle of Python bigints up to C(n, k)."""
    C = [[0] * (n + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        C[i][0] = 1
        for j in range(1, i + 1):
            C[i][j] = C[i - 1][j - 1] + C[i - 1][j]
    return C


def enum_nbits(n: int, w: int) -> int:
    """Integer bits needed for the rank of a weight-w pattern: ceil(log2 C)."""
    c = _binom_table(n)[n][w]
    return max(0, (c - 1).bit_length())


def enum_rank(positions: np.ndarray, n: int) -> int:
    """Lexicographic rank of the sorted set of 1-positions among C(n, w)."""
    C = _binom_table(n)
    w = len(positions)
    rank = 0
    prev = -1
    rem = w
    for p in positions:
        for q in range(prev + 1, int(p)):
            rank += C[n - 1 - q][rem - 1]
        prev = int(p)
        rem -= 1
    return rank


def enum_unrank(rank: int, n: int, w: int) -> np.ndarray:
    """Inverse of enum_rank."""
    C = _binom_table(n)
    positions = np.empty(w, dtype=np.int64)
    q = 0
    rem = w
    for i in range(w):
        while True:
            c = C[n - 1 - q][rem - 1]
            if rank < c:
                break
            rank -= c
            q += 1
        positions[i] = q
        q += 1
        rem -= 1
    return positions


def enum_encode(w: BitWriter, bits: np.ndarray) -> None:
    """Encode a 0/1 vector of known length & weight as its rank."""
    bits = np.asarray(bits).astype(bool).ravel()
    n = bits.size
    pos = np.nonzero(bits)[0]
    nb = enum_nbits(n, len(pos))
    rank = enum_rank(pos, n)
    # write the (possibly >64 bit) rank MSB-first in 32-bit chunks
    for shift in range(((nb + 31) // 32) * 32 - 32, -1, -32):
        chunk_bits = min(32, nb - shift)
        if chunk_bits > 0:
            w.write_bits((rank >> shift) & 0xFFFFFFFF, chunk_bits)


def enum_decode(r: BitReader, n: int, weight: int) -> np.ndarray:
    nb = enum_nbits(n, weight)
    rank = 0
    remaining = nb
    while remaining > 0:
        take = min(32, remaining)
        rank = (rank << take) | r.read_bits(take)
        remaining -= take
    bits = np.zeros(n, dtype=bool)
    if weight:
        bits[enum_unrank(rank, n, weight)] = True
    return bits


# ---------------------------------------------------------------------------
# device-parallel variable-length packing (prefix-sum offset assembly)
# ---------------------------------------------------------------------------

def pack_varlen(values: jnp.ndarray, lengths: jnp.ndarray,
                total_words: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Scatter N variable-length codes (<=32 bits each) into a uint32 stream.

    values[i] holds lengths[i] significant bits (right-aligned); codes are
    laid out MSB-first back to back.  Returns (words uint32[total_words],
    total_bits).  Offsets come from an exclusive cumsum; each code straddles
    at most two words, so the scatter is two segment-XOR adds — the
    parallel-prefix bitstream assembly of BASELINE.json, fully jittable and
    shardable (per-shard streams are merged with psum-scanned base offsets,
    see parallel/bitmerge.py).
    """
    values = jnp.asarray(values, jnp.uint32)
    lengths = jnp.asarray(lengths, jnp.uint32)
    starts = jnp.cumsum(lengths) - lengths  # exclusive prefix
    total_bits = starts[-1] + lengths[-1] if values.size else jnp.uint32(0)
    word_idx = (starts // 32).astype(jnp.int32)
    bit_in = starts % 32
    # split each code across its (at most) two target words, 32-bit math only
    # (uint64 is unavailable without jax x64 mode)
    mask = jnp.where(lengths >= 32, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << jnp.minimum(lengths, 31)) - 1)
    v = values & mask
    end = bit_in + lengths  # <= 63 since bit_in <= 31, lengths <= 32
    hi = jnp.where(end <= 32,
                   v << jnp.clip(32 - end, 0, 31),
                   v >> jnp.clip(end - 32, 0, 31))
    lo = jnp.where(end <= 32, jnp.uint32(0), v << jnp.clip(64 - end, 0, 31))
    words = jnp.zeros(total_words, dtype=jnp.uint32)
    # disjoint bit ranges -> XOR==OR accumulation is race-free under scatter-add
    words = words.at[word_idx].add(hi, mode="drop")
    words = words.at[jnp.minimum(word_idx + 1, total_words - 1)].add(
        lo, mode="drop")
    return words, total_bits


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Big-endian serialize a uint32 stream, trimmed to ceil(total_bits/8)."""
    words = np.asarray(words, dtype=np.uint32)
    by = np.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)],
                  axis=-1).astype(np.uint8).ravel()
    return by.tobytes()[: (int(total_bits) + 7) // 8]
