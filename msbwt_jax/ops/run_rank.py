"""Run-length-compressed device rank: memory scales with RUNS, not positions.

The reference's defining memory property is query-from-compressed: ``RleBWT``
holds ONLY the RLE byte vector plus a sampled index (ref: src/rle_bwt.rs:14-24)
and ``constrain_range`` decodes at most ~one bin of runs per rank
(ref: src/rle_bwt.rs:202-287) — so resident bytes scale with RUNS. The decoded
device tiers (``ops.rank`` / ``ops.packed_rank`` / ``ops.pair_rank``) trade
that away for gather speed at ~1-9 bytes/position. For the msbwt use case —
high-coverage, highly-repetitive read collections where runs are long — this
tier restores the reference's memory scaling on device:

* **Run rows** (``table`` int32 [NR + 2, 40]): each row packs ``RB = 64``
  consecutive runs as u16 words (``len << 3 | sym``, two per int32 lane,
  lanes 8..39) behind an inline checkpoint: lanes 0..5 = per-symbol
  occurrences strictly before the row, lane 6 = the row's global start
  position. 160 bytes per 64 runs = **2.5 B/run**. Runs longer than 8191
  (13-bit length, the reference leaf encoding's own cap,
  ref: src/run_block_av_flat.rs:43-56) are split at build time.
* **Seek table** (``seek`` int32 [n // SP + 1]): row index containing each
  ``SP = 64``-position boundary — 0.0625 B/position.

Rank(sym, pos) = seek gather + TWO adjacent row gathers + an in-row
fixed-width decode (cumsum over 64 run lengths + masked clip-sum on the VPU).
Two candidate rows suffice BY CONSTRUCTION: every full row covers >= RB >= SP
positions (runs are non-empty), so at most one row boundary falls inside any
SP-position window — the row holding ``pos`` is ``seek[pos // SP]`` or the
one after. Three dependent gathers per rank vs the packed tier's one: this is
a CAPACITY tier (fits indexes the decoded tiers cannot), not the speed tier.

Bytes/position vs the decoded tiers (r = mean run length):

  decoded OccIndex   ~1.2 B/pos      packed tier  ~1.2 B/pos
  pair tier          ~8   B/pos      run tier     2.5/r + 0.07 B/pos

The run tier wins memory below the decoded tiers at r > ~2 and is an order
of magnitude smaller at the 30x-coverage regime (r ~ 10-100).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from msbwt_jax.ops.alphabet import VC_LEN
from msbwt_jax.ops.rank import fetch_counts as rank_fetch_counts

RB = 64          # runs per row
SP = 64          # seek spacing in positions; MUST be <= RB (2-row invariant)
MAX_RUN = 8191   # 13-bit run-length cap; longer runs are split at build
_META = 8        # meta lanes per row (occ 0..5, pos0 at 6, lane 7 reserved)
LANES = _META + RB // 2  # 40 int32 lanes = 160 B/row


class RunOccIndex(NamedTuple):
    """Device rank index over run-length-compressed symbols."""

    table: jax.Array    # int32 [NR + 2, LANES] run rows + 2 terminal rows
    seek: jax.Array     # int32 [n // SP + 1] row containing each SP boundary
    starts: jax.Array   # int32 [VC_LEN + 1] C-array
    n: int              # BWT length (static python int)

    @property
    def counts(self) -> jax.Array:
        return jnp.diff(self.starts)

    def device_bytes(self) -> int:
        """Resident device bytes (table + seek)."""
        return int(self.table.size) * 4 + int(self.seek.size) * 4


def _split_runs(syms: np.ndarray, lens: np.ndarray):
    """Split runs longer than MAX_RUN into <= MAX_RUN chunks (host)."""
    syms = np.asarray(syms, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int64)
    if lens.size and int(lens.min()) < 1:
        raise ValueError("run lengths must be >= 1")
    n_chunks = -(-lens // MAX_RUN) if lens.size else lens
    if lens.size == 0 or int(n_chunks.max()) == 1:
        return syms, lens
    total = int(n_chunks.sum())
    out_syms = np.repeat(syms, n_chunks)
    first = np.cumsum(n_chunks) - n_chunks          # first chunk of each run
    within = np.arange(total, dtype=np.int64) - np.repeat(first, n_chunks)
    last_len = lens - (n_chunks - 1) * MAX_RUN      # 1..MAX_RUN
    out_lens = np.where(
        within < np.repeat(n_chunks - 1, n_chunks),
        MAX_RUN,
        np.repeat(last_len, n_chunks),
    )
    return out_syms, out_lens


def build_run_index(syms, lens) -> RunOccIndex:
    """Build the run-tier index from maximal runs (host prep, O(runs)).

    All host work here is proportional to the number of RUNS — nothing
    position-proportional is materialized, matching the reference's
    load-path memory scaling (ref: src/rle_bwt.rs:324-348 reads only the
    compressed bytes).

    >>> from msbwt_jax.ops.alphabet import convert_stoi
    >>> from msbwt_jax.ops.rle import runs_from_symbols
    >>> from msbwt_jax.utils.oracle import naive_bwt
    >>> idx = build_run_index(*runs_from_symbols(convert_stoi(
    ...     naive_bwt(["ACGT", "TGCA"]))))
    >>> int(count_kmers_runs(idx, convert_stoi("ACGT"))[0])
    1
    """
    syms, lens = _split_runs(syms, lens)
    n = int(lens.sum()) if lens.size else 0
    if n >= 2**31:
        raise ValueError(
            "single-device RunOccIndex limited to 2^31-1 symbols; use parallel/"
        )
    r = int(syms.size)
    nr = -(-r // RB) if r else 0
    pad = nr * RB - r
    if pad:
        syms = np.concatenate([syms, np.full(pad, 7, np.uint8)])
        lens = np.concatenate([lens, np.zeros(pad, np.int64)])

    words = (lens.astype(np.uint32) << 3) | syms.astype(np.uint32)  # u16 each
    words = words.reshape(nr, RB) if nr else words.reshape(0, RB)
    packed = (words[:, 0::2] | (words[:, 1::2] << 16)).view(np.int32)

    # per-row start position and per-symbol occ before the row (O(runs))
    row_lens = lens.reshape(nr, RB).sum(axis=1) if nr else np.zeros(0, np.int64)
    pos0 = np.concatenate([[0], np.cumsum(row_lens)])[:-1] if nr else np.zeros(0, np.int64)
    occ_rows = np.zeros((nr, VC_LEN), dtype=np.int64)
    totals = np.zeros(VC_LEN, dtype=np.int64)
    for s in range(VC_LEN):
        sym_lens = np.where(syms == s, lens, 0)
        totals[s] = int(sym_lens.sum())
        if nr:
            contrib = sym_lens.reshape(nr, RB).sum(axis=1)
            occ_rows[:, s] = np.cumsum(contrib) - contrib

    table = np.zeros((nr + 2, LANES), dtype=np.int32)
    if nr:
        table[:nr, :VC_LEN] = occ_rows
        table[:nr, 6] = pos0
        table[:nr, _META:] = packed
    # two terminal rows: rank(pos == n) resolves here; the second keeps the
    # unconditional `row + 1` gather in range under mode='clip'
    table[nr:, :VC_LEN] = totals
    table[nr:, 6] = n

    boundaries = np.arange(n // SP + 1, dtype=np.int64) * SP
    pos0_all = np.concatenate([pos0, [n, n]])
    seek = (np.searchsorted(pos0_all, boundaries, side="right") - 1).astype(
        np.int32
    )

    starts = np.concatenate([[0], np.cumsum(totals)]).astype(np.int32)
    return RunOccIndex(
        table=jnp.asarray(table),
        seek=jnp.asarray(seek),
        starts=jnp.asarray(starts),
        n=n,
    )


def build_run_index_from_bytes(rle_bytes) -> RunOccIndex:
    """Run-tier index straight from the compressed npy byte vector."""
    from msbwt_jax.ops.rle import runs_from_bytes

    syms, counts = runs_from_bytes(rle_bytes)
    return build_run_index(syms, counts.astype(np.int64))


def rank_runs(table: jax.Array, seek: jax.Array, sym: jax.Array,
              pos: jax.Array) -> jax.Array:
    """Batched rank: occurrences of ``sym[i]`` in ``bwt[0:pos[i]]``.

    One seek gather + two adjacent row gathers + fixed-width in-row decode
    (the vectorized analogue of the reference's fm_index seed + linear run
    scan, ref: src/rle_bwt.rs:204-244).
    """
    sym = jnp.asarray(sym, dtype=jnp.int32)
    pos = jnp.asarray(pos, dtype=jnp.int32)
    r0 = jnp.take(seek, pos // SP, mode="clip")
    row_a = jnp.take(table, r0, axis=0, mode="clip")       # [B, LANES]
    row_b = jnp.take(table, r0 + 1, axis=0, mode="clip")
    use_b = pos >= row_b[:, 6]
    row = jnp.where(use_b[:, None], row_b, row_a)

    occ_base = jnp.sum(
        jnp.where(
            jnp.arange(VC_LEN, dtype=jnp.int32)[None, :] == sym[:, None],
            row[:, :VC_LEN],
            0,
        ),
        axis=1,
        dtype=jnp.int32,
    )
    words = row[:, _META:]                                  # [B, RB // 2]
    lo = words & 0xFFFF
    hi = (words >> 16) & 0xFFFF
    runs = jnp.stack([lo, hi], axis=-1).reshape(sym.shape[0], RB)
    rlen = runs >> 3
    rsym = runs & 7
    cstart = jnp.cumsum(rlen, axis=1) - rlen                # run start offsets
    rel = pos - row[:, 6]                                   # in-row offset
    contrib = jnp.clip(rel[:, None] - cstart, 0, rlen)
    local = jnp.sum(
        jnp.where(rsym == sym[:, None], contrib, 0), axis=1, dtype=jnp.int32
    )
    return occ_base + local


def constrain_range_runs(index: RunOccIndex, sym, lo, hi):
    """Batched LF step over the run tier (result-equivalent to
    ref: src/rle_bwt.rs:202-287)."""
    sym = jnp.asarray(sym, dtype=jnp.int32)
    both = rank_runs(index.table, index.seek,
                     jnp.concatenate([sym, sym]), jnp.concatenate([lo, hi]))
    c = index.starts[sym]
    b = lo.shape[0]
    return c + both[:b], c + both[b:]


@functools.partial(jax.jit, static_argnames=("n", "cache_k"))
def _count_kmers_runs_impl(table, seek, starts, n, kmers, lengths,
                           cache=None, cache_k=0):
    B, K = kmers.shape
    lo = jnp.zeros(B, jnp.int32)
    hi = jnp.full(B, n, jnp.int32)

    t_start = 0
    if cache is not None and cache_k > 0 and K >= cache_k:
        from msbwt_jax.ops.rank import _cache_seed

        lo, hi = _cache_seed(cache, kmers, K, cache_k)
        t_start = cache_k

    def step(t, carry):
        lo, hi = carry
        col = K - 1 - t
        sym = kmers[:, col].astype(jnp.int32)
        active = t < lengths
        s = jnp.where(active, sym, 0)
        both = rank_runs(table, seek, jnp.concatenate([s, s]),
                         jnp.concatenate([lo, hi]))
        c = starts[s]
        new_lo, new_hi = c + both[:B], c + both[B:]
        lo = jnp.where(active, new_lo, lo)
        hi = jnp.where(active, new_hi, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(t_start, K, step, (lo, hi))
    return hi - lo


@functools.partial(jax.jit, static_argnames=("n", "cache_k"))
def _cache_fused_runs_impl(table, seek, starts, n, *, cache_k):
    """Prefix-range cache build over the run tier — the run-tier mirror of
    ``ops.rank._cache_fused_impl`` (one program, fixed 6^k buffers)."""
    index = RunOccIndex(table=table, seek=seek, starts=starts, n=n)
    size = VC_LEN ** cache_k
    pows = jnp.asarray([VC_LEN ** i for i in range(cache_k)], jnp.int32)
    codes = jnp.arange(size, dtype=jnp.int32)
    lo = jnp.zeros(size, jnp.int32)
    hi = jnp.full(size, n, jnp.int32)

    def level(level_i, carry):
        lo, hi = carry
        p = pows[level_i - 1]
        sym = (codes // p) % VC_LEN
        rest = codes % p
        return constrain_range_runs(index, sym, jnp.take(lo, rest),
                                    jnp.take(hi, rest))

    lo, hi = jax.lax.fori_loop(1, cache_k + 1, level, (lo, hi))
    return lo, hi


def build_kmer_cache_runs(index: RunOccIndex, cache_k: int):
    """k-mer prefix cache from the run tier (``ops.rank.KmerCache``)."""
    from msbwt_jax.ops.rank import KmerCache

    if cache_k > 8:
        raise ValueError("run-tier cache build supports cache_k <= 8")
    return KmerCache(*_cache_fused_runs_impl(
        index.table, index.seek, index.starts, index.n, cache_k=cache_k))


def count_kmers_runs(index: RunOccIndex, kmers, lengths=None, cache=None,
                     cache_k: int = 0) -> np.ndarray:
    """Batched ``count_kmer`` over the run tier (result-equivalent to
    ``ops.rank.count_kmers``; ref semantics: src/msbwt_core.rs:124-161)."""
    kmers = np.asarray(kmers, dtype=np.uint8)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    if not np.all(kmers < VC_LEN):
        raise AssertionError("k-mer symbols must be < 6")
    B, K = kmers.shape
    if lengths is None:
        lengths = np.full(B, K, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    if cache is not None and cache_k > 0 and K >= cache_k:
        short = lengths < cache_k
        if short.any():
            out = np.empty(B, dtype=np.int64)
            out[short] = count_kmers_runs(index, kmers[short], lengths[short])
            out[~short] = count_kmers_runs(
                index, kmers[~short], lengths[~short],
                cache=cache, cache_k=cache_k,
            )
            return out
    else:
        cache, cache_k = None, 0
    out = _count_kmers_runs_impl(
        index.table, index.seek, index.starts, index.n,
        jnp.asarray(kmers), jnp.asarray(lengths), cache=cache, cache_k=cache_k,
    )
    return rank_fetch_counts(out)
