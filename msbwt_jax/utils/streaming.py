"""Streaming MSBWT construction: read batches arrive incrementally and the
BWT is maintained on device between batches.

This is the batch-granular generalization of the reference's load-and-extend
flow (load an existing BWT into ``DynamicBWT`` and ``insert_string`` more —
ref: src/lib.rs:30-43, test src/dynamic_bwt.rs:734-773), with two device-side
properties:

* the accumulated BWT never leaves the device between batches
  (``build_msbwt(..., device_out=True)``), and
* host work on batch i+1 (parsing, packing, sorting) overlaps the device
  build of batch i via JAX async dispatch — ``add_batch`` returns as soon as
  the device program is enqueued.

Sorted streaming is exact: sorted insertion is input-order independent
(SURVEY.md §2), so feeding batches in any order converges to the same BWT as
one big sorted build; each extension batch finds its terminator slots with
the batched cyclic backward search (``ops.bcr.terminator_positions``).
Chronological streaming appends each batch's terminators in arrival order,
matching repeated ``insert_string(s, false)``.
"""

from __future__ import annotations

import numpy as np

from msbwt_jax.ops.bcr import build_msbwt


class StreamingBuilder:
    """Incremental builder: ``add_batch`` reads, then ``finish`` -> BWT.

    Two batches equal one sorted one-shot build (order independence):

    >>> import numpy as np
    >>> from msbwt_jax.ops.alphabet import convert_itos, convert_stoi
    >>> from msbwt_jax.ops.bcr import encode_reads
    >>> from msbwt_jax.utils.oracle import naive_bwt
    >>> b = StreamingBuilder()
    >>> b.add_batch(*encode_reads([convert_stoi("ACGT")]))
    >>> b.add_batch(*encode_reads([convert_stoi("TGCA")]))
    >>> b.string_count
    2
    >>> convert_itos(b.finish()) == naive_bwt(["ACGT", "TGCA"])
    True
    """

    def __init__(self, sorted_insert: bool = True):
        self.sorted_insert = sorted_insert
        self._bwt = None          # device array (decoded symbols)
        self._string_count = 0
        self._rot_max = 0         # longest rotation (read length + 1) so far

    @property
    def string_count(self) -> int:
        return self._string_count

    def add_batch(self, reads: np.ndarray, lengths: np.ndarray) -> None:
        """Fold one ``[N, L] u8 / [N] i32`` batch into the BWT."""
        reads = np.asarray(reads, dtype=np.uint8)
        lengths = np.asarray(lengths, dtype=np.int32)
        if reads.shape[0] == 0:
            return
        self._bwt = build_msbwt(
            reads,
            lengths,
            sorted_insert=self.sorted_insert,
            base=self._bwt,
            base_string_count=self._string_count,
            base_rot_max=self._rot_max if self._rot_max else None,
            device_out=True,
        )
        self._string_count += int(reads.shape[0])
        self._rot_max = max(self._rot_max, int(lengths.max()) + 1)

    def finish(self) -> np.ndarray:
        """Return the accumulated decoded BWT on host (uint8 [n])."""
        if self._bwt is None:
            return np.zeros(0, dtype=np.uint8)
        return np.asarray(self._bwt)

    # --- checkpoint / resume (elastic recovery for long ingestions; the
    # reference's "the npy IS the checkpoint" flow, ref: src/lib.rs:30-43,
    # at batch granularity) ---

    def checkpoint(self, path: str) -> None:
        """Persist the accumulated BWT + builder state to ``path`` (npy with
        the reference's exact header) and ``path + '.meta.json'``."""
        import json

        from msbwt_jax.ops.rle import runs_from_symbols
        from msbwt_jax.utils.npy import save_bwt_runs

        save_bwt_runs(*runs_from_symbols(self.finish()), path)
        with open(path + ".meta.json", "w") as fp:
            json.dump(
                {
                    "string_count": self._string_count,
                    "rot_max": self._rot_max,
                    "sorted_insert": self.sorted_insert,
                },
                fp,
            )

    @classmethod
    def restore(cls, path: str) -> "StreamingBuilder":
        """Resume a checkpointed ingestion; subsequent ``add_batch`` calls
        extend the restored BWT."""
        import json

        from msbwt_jax.ops.rle import decode_symbols
        from msbwt_jax.utils.npy import load_bwt_bytes

        with open(path + ".meta.json") as fp:
            meta = json.load(fp)
        b = cls(sorted_insert=bool(meta["sorted_insert"]))
        decoded = decode_symbols(load_bwt_bytes(path))
        if decoded.size:
            b._bwt = decoded
        b._string_count = int(meta["string_count"])
        b._rot_max = int(meta["rot_max"])
        return b


def build_msbwt_streaming(
    reads: np.ndarray,
    lengths: np.ndarray,
    batch_size: int,
    sorted_insert: bool = True,
) -> np.ndarray:
    """Convenience wrapper: stream a read matrix through ``StreamingBuilder``
    in ``batch_size`` chunks. Result equals one-shot ``build_msbwt``."""
    b = StreamingBuilder(sorted_insert=sorted_insert)
    n = int(np.asarray(reads).shape[0])
    for i in range(0, n, batch_size):
        b.add_batch(reads[i : i + batch_size], lengths[i : i + batch_size])
    return b.finish()
