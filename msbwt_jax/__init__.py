"""msbwt_jax — a multi-string BWT engine for accelerators, in JAX.

A from-scratch JAX/XLA re-design with the full capabilities of
HudsonAlpha/rust-msbwt (msbwt2): MSBWT construction from FASTA/FASTQ read
collections, run-length-encoded BWT storage byte-compatible with the
``comp_msbwt.npy`` numpy format, and FM-index rank / ``count_kmer`` queries as
batched backward search over device-resident occurrence tables.

Layer map (mirrors SURVEY.md):
  * ``ops.alphabet``   — L0 alphabet/encoding tables      (ref: src/string_util.rs)
  * ``ops.rle``        — L1 RLE byte-stream codec         (ref: src/bwt_converter.rs)
  * ``utils.npy``      — L1 numpy container contract      (ref: src/bwt_converter.rs:102-184)
  * ``models.rle_bwt`` — L2a static query engine          (ref: src/rle_bwt.rs)
  * ``models.dynamic`` — L2b dynamic construction engine  (ref: src/dynamic_bwt.rs)
  * ``ops.bcr``        — batched column-wise construction (replaces rle_bplus_tree.rs)
  * ``ops.merge``      — Holt–McMillan interleave merge   (ref: src/bwt_util.rs:21-141)
  * ``utils.oracle``   — naive BWT oracle for tests       (ref: src/bwt_util.rs:154-171)
  * ``parallel``       — multi-device sharding (no reference equivalent; README.md:42
                         states the reference "is not parallelized")
  * ``cli``            — msbwt2-build / msbwt2-convert    (ref: src/bin/*.rs)
"""

__version__ = "0.1.0"

from msbwt_jax.models.core import BWTRange  # noqa: F401
from msbwt_jax.models.rle_bwt import RleBWT  # noqa: F401
from msbwt_jax.models.dynamic import DynamicBWT, create_from_fastx  # noqa: F401
