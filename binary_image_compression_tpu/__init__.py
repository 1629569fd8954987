"""binary_image_compression_tpu — a lossless binary-image compression framework in JAX.

A from-scratch re-design (JAX / XLA / shard_map) of the capabilities of the
reference C++ research codebase ``nacho-pancho/binary-image-compression``:

* bit-packed boolean matrix algebra        -> :mod:`.ops.bitpack` (uint32 lanes,
  popcount/parity via ``lax``, GF(2) matmuls)
* PBM / PGM / PPM image I/O + bitplanes    -> :mod:`.utils.pnm`, :mod:`.utils.bitplanes`
* causal binary prediction (MED / GF(2))   -> :mod:`.ops.predict`
* Golomb / exp-Golomb / enumerative coding -> :mod:`.ops.entropy`
* real bitstream assembly (NEW: the reference only ever *estimated*
  codelengths)                             -> :mod:`.ops.bitstream`, :mod:`.models.codec`
* windowed self-referential patch codecs (compress1..8)
                                           -> :mod:`.models.compress`
* binary dictionary learning (BSVD)        -> :mod:`.models.bsvd`
* multi-chip sharding, halo exchange, bitstream merge
                                           -> :mod:`.parallel`

Reference parity: every estimator reproduces the reference's codelength
arithmetic bit-for-bit (see tests/goldens).  Deliberate, documented deviations
from reference *undefined behaviour* are collected in ``DEVIATIONS.md``.
"""

__version__ = "0.1.0"

from . import ops, models, parallel, utils  # noqa: F401
