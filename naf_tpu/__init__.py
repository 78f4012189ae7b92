"""naf_tpu — a nucleotide archive framework with a JAX device path.

A from-scratch reimplementation of the capabilities of NAF (Nucleotide
Archival Format, reference: KirillKryukov/naf):

- the byte-at-a-time streaming C state machine of the reference is replaced
  by a block-parallel array program (JAX/XLA) for the per-byte transforms
  (classify, compaction, 4-bit pack/unpack, masking, render) on a GPU, and
  by a native C++ host runtime;
- multi-card scaling uses ``jax.sharding.Mesh`` + ``shard_map`` over blocks
  with an associative carry-state algebra for block boundaries;
- the container layer writes/reads NAF v1/v2 archives compatible with the
  reference ``ennaf``/``unnaf`` binaries.

Reference layout (for parity checking): /root/reference/ennaf, /root/reference/unnaf.
"""

from .version import __version__

__all__ = ["__version__"]
