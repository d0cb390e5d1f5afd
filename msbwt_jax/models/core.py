"""L2 core — the shared BWT interface.

Mirrors the reference's ``BWT`` trait (ref: src/msbwt_core.rs:28-161):
``load_vector``, ``load_numpy_file``, ``get_symbol_count``, ``get_total_size``,
``constrain_range`` and the default ``count_kmer`` backward-search loop
(ref: src/msbwt_core.rs:124-161 — asserts all symbols < 6 at :127 and
early-exits on an empty range at :151-153).

The batched addition over the reference trait is the
``count_kmers`` entry point: a ``[B, K]`` int batch answered in one device
program (masked fixed-iteration backward search instead of the scalar early
exit — SURVEY.md §7 layer 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from msbwt_jax.ops.alphabet import VC_LEN


@dataclasses.dataclass(frozen=True)
class BWTRange:
    """Half-open range [l, h) in the BWT (ref: src/msbwt_core.rs:19-24).

    >>> rng = BWTRange(2, 7)
    >>> rng.h - rng.l
    5
    """

    l: int = 0
    h: int = 0


class BWTBase:
    """Shared query interface for all BWT types."""

    def load_vector(self, bwt: np.ndarray) -> None:
        raise NotImplementedError

    def load_numpy_file(self, filename: str) -> None:
        raise NotImplementedError

    def get_symbol_count(self, symbol: int) -> int:
        raise NotImplementedError

    def get_total_size(self) -> int:
        raise NotImplementedError

    def constrain_range(self, sym: int, input_range: BWTRange) -> BWTRange:
        raise NotImplementedError

    def count_kmer(self, kmer) -> int:
        """Occurrences of an integer-encoded k-mer (ref: src/msbwt_core.rs:124-161).

        >>> from msbwt_jax.models.dynamic import DynamicBWT
        >>> bwt = DynamicBWT()
        >>> bwt.insert_string("ACGT", True)
        >>> bwt.insert_string("TGCA", True)
        >>> bwt.count_kmer([1, 2, 3, 5])  # "ACGT"
        1
        >>> bwt.count_kmer([3, 2])  # "GC"
        1
        """
        kmer = np.asarray(kmer, dtype=np.uint8)
        assert np.all(kmer < VC_LEN), "k-mer symbols must be < 6"
        rng = BWTRange(0, self.get_total_size())
        for c in kmer[::-1]:
            if rng.h == rng.l:
                return 0
            rng = self.constrain_range(int(c), rng)
        return rng.h - rng.l

    def kmer_profile(self, reads, k: int) -> np.ndarray:
        """Counts of every length-``k`` window of each read: ``[B, L]`` int
        reads -> ``[B, L - k + 1]`` counts.

        The k-mer profile drives the original msbwt's headline application
        (read error correction: low-count windows flag errors). Windows are
        materialized and answered as one batched ``count_kmers`` program —
        BWT ranges only extend leftward, so sliding windows cannot share
        search state without a bidirectional index.
        """
        reads = np.asarray(reads, dtype=np.uint8)
        if reads.ndim == 1:
            reads = reads[None, :]
        B, L = reads.shape
        if not 1 <= k <= L:
            raise ValueError(f"k={k} out of range for reads of length {L}")
        w = L - k + 1
        windows = np.lib.stride_tricks.sliding_window_view(reads, k, axis=1)
        counts = self.count_kmers(windows.reshape(B * w, k))
        return counts.reshape(B, w)

    def count_kmers_bidirectional(self, kmers, lengths=None) -> np.ndarray:
        """Forward + reverse-complement counts per k-mer: the double-stranded
        convention of the original msbwt's applications (reads sample both
        strands, so motif abundance = fw + rc occurrences; fmlrc-style error
        correction consumes exactly this). Palindromic k-mers count both
        directions, matching that convention.

        >>> from msbwt_jax.models.dynamic import DynamicBWT
        >>> bwt = DynamicBWT()
        >>> bwt.insert_string("ACGT", True)
        >>> bwt.insert_string("TGCA", True)
        >>> import numpy as np
        >>> bwt.count_kmers_bidirectional(np.array([[3, 2]])).tolist()  # GC
        [2]
        """
        from msbwt_jax.ops.alphabet import COMPLEMENT_INT

        kmers = np.asarray(kmers, dtype=np.uint8)
        if kmers.ndim == 1:
            kmers = kmers[None, :]
        B, K = kmers.shape
        if lengths is None:
            lengths = np.full(B, K, dtype=np.int32)
        lengths = np.asarray(lengths, dtype=np.int32)
        comp = np.asarray(COMPLEMENT_INT, dtype=np.uint8)[kmers]
        # reverse each row's right-aligned window, keeping right alignment
        j = np.arange(K, dtype=np.int64)[None, :]
        src = 2 * K - lengths[:, None] - 1 - j
        valid = j >= (K - lengths[:, None])
        rc = np.where(
            valid, np.take_along_axis(comp, np.clip(src, 0, K - 1), axis=1), 0
        ).astype(np.uint8)
        counts = self.count_kmers(
            np.vstack([kmers, rc]), np.concatenate([lengths, lengths])
        )
        return counts[:B] + counts[B:]

    def count_kmers_approx(self, kmers, lengths=None,
                           max_mismatch: int = 1) -> np.ndarray:
        """Occurrences within Hamming distance ``max_mismatch`` (0 or 1).

        Distance-1 occurrences are EXACTLY the disjoint union of exact
        occurrences of every single-substitution variant (each text window
        matches exactly one variant string), so this is one batched
        ``count_kmers`` call over ``B * (1 + 4*len)`` rows — the
        SNP-tolerant counting fmlrc-class tools compute implicitly.
        Substitutions range over the non-terminator alphabet (A C G N T).

        >>> import numpy as np
        >>> from msbwt_jax.models.dynamic import DynamicBWT
        >>> bwt = DynamicBWT()
        >>> bwt.insert_strings(["ACGT", "AGGT"], sorted=True)
        >>> int(bwt.count_kmers_approx(np.array([[1, 2, 3]]))[0])  # "ACG"+-1
        2
        """
        kmers = np.asarray(kmers, dtype=np.uint8)
        if kmers.ndim == 1:
            kmers = kmers[None, :]
        B, K = kmers.shape
        if lengths is None:
            lengths = np.full(B, K, dtype=np.int32)
        lengths = np.asarray(lengths, dtype=np.int32)
        exact = np.asarray(self.count_kmers(kmers, lengths), dtype=np.int64)
        if max_mismatch == 0:
            return exact
        if max_mismatch != 1:
            raise NotImplementedError("max_mismatch must be 0 or 1")
        active = np.arange(K)[None, :] >= (K - lengths[:, None])   # [B, K]
        cand = np.arange(1, VC_LEN, dtype=np.uint8)[None, None, :]
        ok = active[:, :, None] & (cand != kmers[:, :, None])      # [B, K, 5]
        b_idx, p_idx, c_idx = np.nonzero(ok)
        if b_idx.size == 0:
            return exact
        variants = kmers[b_idx].copy()
        variants[np.arange(b_idx.size), p_idx] = (c_idx + 1).astype(np.uint8)
        vcounts = np.asarray(
            self.count_kmers(variants, lengths[b_idx]), dtype=np.int64
        )
        out = exact.copy()
        np.add.at(out, b_idx, vcounts)
        return out

    def count_kmers(self, kmers, lengths=None) -> np.ndarray:
        """Batched ``count_kmer``: ``[B, K]`` right-aligned int k-mers -> ``[B]``.

        Default implementation loops on host; device-backed models override
        with a single jitted program.
        """
        kmers = np.asarray(kmers, dtype=np.uint8)
        if kmers.ndim == 1:
            kmers = kmers[None, :]
        B, K = kmers.shape
        if lengths is None:
            lengths = np.full(B, K, dtype=np.int32)
        out = np.zeros(B, dtype=np.uint64)
        for i in range(B):
            out[i] = self.count_kmer(kmers[i, K - int(lengths[i]):])
        return out
