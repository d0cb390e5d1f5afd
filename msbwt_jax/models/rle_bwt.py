"""L2a — the static RLE BWT query engine.

Load-then-query engine with the same observable behavior as the reference's
``RleBWT`` (ref: src/rle_bwt.rs): loads the ``comp_msbwt.npy`` RLE byte
vector, computes symbol totals, and answers ``constrain_range`` /
``count_kmer``. Two index structures are built:

* the **device occurrence index** (``ops.rank.OccIndex``) — fixed-position
  sampled occ tables + decoded symbols on device; this is the production
  query path (batched ``count_kmers``).
* the **parity FM-index** — the reference's run-boundary-sampled
  ``fm_index``/``ref_index`` structure (ref: src/rle_bwt.rs:387-467,
  ``index_length = ceil(total/2^bin_power)+1`` at :390; for each bin boundary
  the first run whose span crosses it is recorded: byte offset at :422,444
  and per-symbol occurrences before that run at :423-425; final entry holds
  end-of-BWT totals and ``ref_index = len(bwt)`` at :453-457). Kept because
  it is part of the reference's observable API surface and pins the exact
  numeric tables tested at src/rle_bwt.rs:536-599.
"""

from __future__ import annotations

import numpy as np

from msbwt_jax.models.core import BWTBase, BWTRange
from msbwt_jax.ops import rank as rank_ops
from msbwt_jax.ops.alphabet import VC_LEN
from msbwt_jax.ops.rle import (
    decode_symbols,
    decode_symbols_device,
    rle_meta,
    runs_from_bytes_with_offsets,
)
from msbwt_jax.utils.npy import load_bwt_bytes


def build_sampled_fm_index(
    rle_bytes: np.ndarray, bin_power: int
) -> tuple[np.ndarray, np.ndarray]:
    """Reference-layout sampled FM-index from RLE bytes (vectorized).

    Returns ``(ref_index [L], fm_index [VC_LEN, L])`` with the exact semantics
    of ``construct_fmindex`` (ref: src/rle_bwt.rs:387-467): for bin boundary
    ``p = bin_id * 2^bin_power``, find the first run whose end exceeds ``p``;
    record its byte offset and the per-symbol counts before its start.
    """
    syms, counts, byte_starts = runs_from_bytes_with_offsets(rle_bytes)
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    bin_size = 1 << bin_power
    index_length = int(np.ceil(total / bin_size)) + 1 if total else 1

    ref_index = np.zeros(index_length, dtype=np.uint64)
    fm_index = np.zeros((VC_LEN, index_length), dtype=np.uint64)
    if total == 0:
        return ref_index, fm_index

    run_ends = np.cumsum(counts)
    # per-symbol occurrences strictly before each run's start: [R, VC_LEN]
    one_hot = (syms[:, None] == np.arange(VC_LEN, dtype=np.uint8)[None, :])
    occ_before = np.zeros((syms.size, VC_LEN), dtype=np.int64)
    np.cumsum(one_hot * counts[:, None], axis=0, out=occ_before)
    occ_before = np.vstack([np.zeros((1, VC_LEN), np.int64), occ_before[:-1]])

    boundaries = np.arange(index_length - 1, dtype=np.int64) * bin_size
    run_idx = np.searchsorted(run_ends, boundaries, side="right")
    ref_index[:-1] = byte_starts[run_idx].astype(np.uint64)
    fm_index[:, :-1] = occ_before[run_idx].T.astype(np.uint64)

    # final entry: end-of-BWT totals (ref: src/rle_bwt.rs:453-457)
    ref_index[-1] = np.asarray(rle_bytes).size
    fm_index[:, -1] = (occ_before[-1] + one_hot[-1] * counts[-1]).astype(np.uint64)
    return ref_index, fm_index


class RleBWT(BWTBase):
    """Static query engine over a compressed BWT (ref: src/rle_bwt.rs:14-24).

    >>> bwt = RleBWT()
    >>> bwt.load_vector([13, 9, 10, 8, 11, 9, 13, 10, 11, 8])  # {ACGT, TGCA}
    >>> bwt.get_total_size()
    10
    >>> bwt.count_kmer([1, 2, 3, 5])  # "ACGT"
    1
    >>> from msbwt_jax.models.core import BWTRange
    >>> bwt.constrain_range(5, BWTRange(0, 10))  # rows prefixed "T"
    BWTRange(l=8, h=10)
    """

    def __init__(self, bin_power: int = 8):
        # default bin_power 8 (ref: src/rle_bwt.rs:28-29); configurable like
        # ``with_bin_power`` (ref: src/rle_bwt.rs:309-322)
        self.bin_power = bin_power
        self.bwt = np.zeros(0, dtype=np.uint8)  # RLE bytes
        self.symbol_counts = np.zeros(VC_LEN, dtype=np.uint64)
        self.start_index = np.zeros(VC_LEN, dtype=np.uint64)
        self.end_index = np.zeros(VC_LEN, dtype=np.uint64)
        self.total_size = 0
        self.n_runs = 0
        self._fm = None
        self._decoded = None
        self._decoded_padded = None
        self._occ_np = None
        self._device_index: rank_ops.OccIndex | None = None
        self._packed_index = None
        self._run_index = None

    @classmethod
    def with_bin_power(cls, bin_power: int) -> "RleBWT":
        return cls(bin_power=bin_power)

    # --- loading (ref: src/rle_bwt.rs:59-155,324-348) ---

    def load_vector(self, bwt) -> None:
        self.bwt = np.asarray(bwt, dtype=np.uint8)
        self._standard_init()

    def load_numpy_file(self, filename: str) -> None:
        self.bwt = load_bwt_bytes(filename)
        self._standard_init()

    def _standard_init(self) -> None:
        """Eager work is ONE chunked pass over the compressed bytes (the
        equivalent of ``calculate_totals``, ref: src/rle_bwt.rs:352-384) —
        peak host memory stays ~= the byte vector itself, matching the
        reference's load-from-compressed scaling (ref: src/rle_bwt.rs:14-24).
        Everything else — the parity FM tables, host scalar-rank
        structures, the decoded array, every device index — is derived
        lazily by the path that needs it."""
        n, counts, n_runs = rle_meta(self.bwt)
        self.total_size = n
        self.n_runs = n_runs
        self.symbol_counts = counts.astype(np.uint64)
        csum = np.cumsum(self.symbol_counts)
        self.start_index = (csum - self.symbol_counts).astype(np.uint64)
        self.end_index = csum.astype(np.uint64)
        # drop every derived structure from a previously loaded BWT — they
        # hold state of the OLD index and would silently return wrong counts
        self._fm = None
        self._decoded = None
        self._decoded_padded = None
        self._occ_np = None
        self._device_index = None
        self._packed_index = None
        self._run_index = None
        self._kmer_cache = None
        self._cache_k = 0
        self._pair_index = None

    # --- parity FM-index, lazy (ref layout, ref: src/rle_bwt.rs:387-467) ---

    @property
    def fm_index(self) -> np.ndarray:
        if self._fm is None:
            self._fm = build_sampled_fm_index(self.bwt, self.bin_power)
        return self._fm[1]

    @property
    def ref_index(self) -> np.ndarray:
        if self._fm is None:
            self._fm = build_sampled_fm_index(self.bwt, self.bin_power)
        return self._fm[0]

    def _host_rank_structs(self):
        """Host occ checkpoints + padded decode for SCALAR queries — lazy:
        the batched device path never materializes these."""
        if self._occ_np is None:
            self._decoded = decode_symbols(self.bwt)
            n = self.total_size
            nb = max(1, -(-n // rank_ops.BIN))
            padded = np.full(nb * rank_ops.BIN, 7, dtype=np.uint8)
            padded[:n] = self._decoded
            per_bin = (
                padded.reshape(nb, rank_ops.BIN)[:, :, None]
                == np.arange(VC_LEN, dtype=np.uint8)[None, None, :]
            ).sum(axis=1)
            self._occ_np = np.vstack(
                [np.zeros((1, VC_LEN), np.int64), np.cumsum(per_bin, axis=0)]
            )
            self._decoded_padded = padded
        return self._occ_np, self._decoded_padded

    @property
    def device_index(self) -> rank_ops.OccIndex:
        """Decoded device index, built by decoding the compressed bytes ON
        DEVICE (``ops.rle.decode_symbols_device``): the wire carries the RLE
        bytes and the host never holds the decoded array."""
        if self._device_index is None:
            dec_dev = decode_symbols_device(self.bwt, self.total_size)
            self._device_index = rank_ops.build_occ_index(
                dec_dev, self.total_size
            )
        return self._device_index

    def enable_kmer_cache(self, cache_k: int = 8) -> None:
        """Precompute ranges of all length-``cache_k`` strings so batched
        queries skip their first ``cache_k`` LF steps (the reference's
        unshipped cache idea, ref: src/msbwt_core.rs:133-146)."""
        idx = self.device_index
        self._kmer_cache = rank_ops.build_kmer_cache(
            idx.bwt, idx.occ, idx.starts, idx.n, cache_k
        )
        self._cache_k = cache_k

    # --- queries ---

    def get_symbol_count(self, symbol: int) -> int:
        return int(self.symbol_counts[symbol])

    def get_total_size(self) -> int:
        return self.total_size

    def _rank(self, sym: int, pos: int) -> int:
        occ_np, decoded_padded = self._host_rank_structs()
        b, r = divmod(pos, rank_ops.BIN)
        base = int(occ_np[b, sym])
        if r:
            w = decoded_padded[b * rank_ops.BIN : b * rank_ops.BIN + r]
            base += int(np.count_nonzero(w == sym))
        return base

    def constrain_range(self, sym: int, input_range: BWTRange) -> BWTRange:
        """Result-equivalent to the reference's RLE-decoding scan
        (ref: src/rle_bwt.rs:202-287)."""
        c = int(self.start_index[sym])
        return BWTRange(
            l=c + self._rank(sym, input_range.l),
            h=c + self._rank(sym, input_range.h),
        )

    @property
    def packed_index(self):
        """Packed single-gather rank index (ops.packed_rank) — one 128-byte
        row gather per rank."""
        if self._packed_index is None:
            from msbwt_jax.ops.packed_rank import pack_index

            self._packed_index = pack_index(self.device_index)
        return self._packed_index

    def enable_pair_index(self) -> None:
        """Build the 2-step (symbol-pair) rank index and route batched
        queries through it. Halves the dependent gather rounds, which pays
        on big, gather-bound indexes; small indexes are served by the
        single-step path. Costs 8 bytes/symbol of extra device memory
        (``ops.pair_rank``)."""
        from msbwt_jax.ops.pair_rank import build_pair_index

        self._pair_index = build_pair_index(self.device_index)

    def save_query_indexes(self, path: str) -> None:
        """Persist every derived query index this engine has built (packed
        table, pair index, k-mer cache) as one ``.npz`` sidecar — a query
        service restarts with :meth:`load_query_indexes` instead of
        re-deriving (``utils.checkpoint.save_query_pack``)."""
        from msbwt_jax.utils.checkpoint import save_query_pack

        # Save what was actually built — the ``packed_index`` property
        # DERIVES the table (plus a multi-GB host copy at big n), which a
        # pair-only engine never needs. Only fall back to deriving it when
        # no index exists at all, so the pack is never empty.
        packed = self._packed_index
        pair = getattr(self, "_pair_index", None)
        if packed is None and pair is None:
            packed = self.packed_index
        save_query_pack(
            path,
            packed=packed,
            pair=pair,
            cache=getattr(self, "_kmer_cache", None),
            cache_k=getattr(self, "_cache_k", 0) or 0,
        )

    def load_query_indexes(self, path: str) -> None:
        """Install indexes saved by :meth:`save_query_indexes`. The pack is
        validated against the loaded BWT (length + C array)."""
        from msbwt_jax.utils.checkpoint import load_query_pack

        packed, pair, cache, cache_k = load_query_pack(path)
        src = packed if packed is not None else pair
        if src is None:
            raise IOError(f"empty query pack: {path!r}")
        if int(src.n) != self.total_size:
            raise IOError(
                f"query pack is for a different BWT: n={int(src.n)} "
                f"!= {self.total_size}"
            )
        want = np.concatenate([
            self.start_index.astype(np.int64), [self.total_size]
        ])
        if not np.array_equal(np.asarray(src.starts, np.int64), want):
            raise IOError("query pack C array mismatch (different BWT)")
        if packed is not None:
            self._packed_index = packed
        if pair is not None:
            self._pair_index = pair
        if cache is not None:
            self._kmer_cache = cache
            self._cache_k = cache_k

    # Tier thresholds. Neither is measured on the H100 yet.
    # Past this size the 2-step pair index (plus a prefix cache) serves
    # batched queries: it halves the dependent gather rounds.
    PAIR_AUTO_MIN_SYMBOLS = 32_000_000
    # cache tier auto-built alongside the pair index: for 21-mers,
    # rounds = ceil((21-k)/2), so 6^9 costs the same 6 rounds as 6^10 at a
    # sixth of the table
    CACHE_AUTO_K = 9
    # the run tier's prefix cache is capped at 6^8 (run-tier cache build)
    RUN_CACHE_AUTO_K = 8
    # share of the device's allocatable memory (memory_stats bytes_limit)
    # the decoded tiers may claim before the auto-policy switches to the
    # run-compressed tier; the rest is left for query batches and build
    # buffers. Override: MSBWT_DEVICE_BUDGET_GB.
    DEVICE_BUDGET_FRACTION = 0.75

    def enable_run_index(self) -> None:
        """Build the run-length-compressed device tier (``ops.run_rank``):
        ~2.5 B/run + 0.07 B/position instead of the decoded tiers'
        1-9 B/position — the reference's query-from-compressed memory
        scaling (ref: src/rle_bwt.rs:14-24), on device. Three dependent
        gathers per rank vs the packed tier's one: a CAPACITY tier for
        indexes the decoded tiers cannot fit."""
        from msbwt_jax.ops.run_rank import build_run_index_from_bytes

        self._run_index = build_run_index_from_bytes(self.bwt)

    def device_budget_bytes(self) -> float | None:
        """Device bytes the decoded tiers may claim: ``MSBWT_DEVICE_BUDGET_GB``
        if set, else :attr:`DEVICE_BUDGET_FRACTION` of the device's own
        ``memory_stats()["bytes_limit"]``, else None (the device reports no
        limit, and the policy invents none)."""
        import os

        import jax

        env = os.environ.get("MSBWT_DEVICE_BUDGET_GB")
        if env:
            return float(env) * 1e9
        stats = jax.devices()[0].memory_stats() or {}
        limit = stats.get("bytes_limit")
        if not limit:
            return None
        return self.DEVICE_BUDGET_FRACTION * float(limit)

    def _auto_run_tier(self) -> bool:
        """True when the batched path should use the run tier: forced via
        ``MSBWT_RUN_TIER=1``, or the decoded+pair tiers would exceed the
        device budget while the run tier is smaller."""
        import os

        flag = os.environ.get("MSBWT_RUN_TIER")
        if flag == "1":
            return True
        if flag == "0":
            return False
        n = self.total_size
        pair_bytes = 9 * n  # decoded u8 (1 B) + pair rows (~8 B)/position
        budget = self.device_budget_bytes()
        if budget is None or pair_bytes <= budget:
            return False
        from msbwt_jax.ops import run_rank

        run_bytes = (
            run_rank.LANES * 4 * -(-self.n_runs // run_rank.RB)
            + 4 * (n // run_rank.SP)
        )
        return run_bytes < pair_bytes

    def count_kmers(self, kmers, lengths=None) -> np.ndarray:
        """Batched device path — the production query engine. Indexes past
        ``PAIR_AUTO_MIN_SYMBOLS`` automatically build and use the 2-step
        pair index plus a 6^9 prefix-range cache (disable with
        ``MSBWT_NO_PAIR=1`` / ``MSBWT_NO_CACHE=1``); indexes whose
        decoded tiers would blow the device budget use the run-compressed
        tier instead (``MSBWT_RUN_TIER`` forces/disables)."""
        import os

        if self._run_index is None and self._pair_index is None \
                and self._auto_run_tier():
            self.enable_run_index()
        if self._run_index is not None:
            from msbwt_jax.ops.run_rank import (
                build_kmer_cache_runs,
                count_kmers_runs,
            )

            if (
                not getattr(self, "_cache_k", 0)
                and self.total_size >= self.PAIR_AUTO_MIN_SYMBOLS
                and not os.environ.get("MSBWT_NO_CACHE")
            ):
                self._kmer_cache = build_kmer_cache_runs(
                    self._run_index, self.RUN_CACHE_AUTO_K
                )
                self._cache_k = self.RUN_CACHE_AUTO_K
            return count_kmers_runs(
                self._run_index, kmers, lengths,
                cache=getattr(self, "_kmer_cache", None),
                cache_k=getattr(self, "_cache_k", 0),
            )
        if (
            getattr(self, "_pair_index", None) is None
            and self.total_size >= self.PAIR_AUTO_MIN_SYMBOLS
            and not os.environ.get("MSBWT_NO_PAIR")
        ):
            self.enable_pair_index()
        if (
            not getattr(self, "_cache_k", 0)
            and self.total_size >= self.PAIR_AUTO_MIN_SYMBOLS
            and not os.environ.get("MSBWT_NO_CACHE")
        ):
            self.enable_kmer_cache(self.CACHE_AUTO_K)
        if getattr(self, "_pair_index", None) is not None:
            from msbwt_jax.ops.pair_rank import count_kmers_pair

            return count_kmers_pair(
                self._pair_index, kmers, lengths,
                cache=getattr(self, "_kmer_cache", None),
                cache_k=getattr(self, "_cache_k", 0),
            )
        from msbwt_jax.ops.packed_rank import count_kmers_packed

        return count_kmers_packed(
            self.packed_index, kmers, lengths,
            cache=getattr(self, "_kmer_cache", None),
            cache_k=getattr(self, "_cache_k", 0),
        )

    def locate_kmers(self, kmers, lengths=None):
        """Map every k-mer occurrence to ``(query_idx, read_id, offset)``
        (the original msbwt's ``findReadsMatchingSeq``; read ids are
        lexicographic — the id space of ``ops.extract.extract_reads``)."""
        from msbwt_jax.ops.extract import locate_kmers

        return locate_kmers(
            self.device_index, kmers, self.get_symbol_count(0),
            lengths=lengths,
        )
