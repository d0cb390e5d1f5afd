"""Device rank engine: sampled occurrence tables + batched LF backward search.

This is the batched device replacement for the reference's query hot loop
(``RleBWT::constrain_range``, ref: src/rle_bwt.rs:202-287): instead of
decoding <=1 bin of RLE bytes per rank on a scalar CPU, we hold the decoded
BWT on device next to occurrence checkpoints sampled at FIXED positions
(an internal representation change — only query *results* must match the
reference, SURVEY.md §7 layer 2) and answer a rank with one table gather
plus a fixed-width in-bin reduction. Batches of k-mers run as one jitted
program: ``k`` masked LF steps, two ranks per step
(ref semantics: src/msbwt_core.rs:124-161).

All arrays are int32-indexed; ``build_occ_index`` rejects BWTs with more than
2**31 - 1 symbols (the sharded path in ``parallel/`` is the scale-out story).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from msbwt_jax.ops.alphabet import VC_LEN

BIN = 128  # occurrence checkpoint spacing (positions)
_PAD_SYMBOL = 7  # never matches a real symbol (0..5)


class OccIndex(NamedTuple):
    """Device-resident rank index over a decoded BWT."""

    bwt: jax.Array      # uint8 [nb * BIN] decoded symbols, padded with 7
    occ: jax.Array      # int32 [nb + 1, 6] counts of each symbol before bin start
    starts: jax.Array   # int32 [VC_LEN + 1] C-array: starts[c] = # symbols < c
    n: int              # true BWT length (static python int)

    @property
    def counts(self) -> jax.Array:
        return self.occ[-1]


def build_occ_index(decoded, n: int | None = None) -> OccIndex:
    """Build the occurrence index from a decoded symbol array (device, one pass).

    Equivalent information to ``calculate_totals`` + ``construct_fmindex``
    (ref: src/rle_bwt.rs:352-467) but sampled at fixed positions and computed
    with reshape + reduce + cumsum instead of a sequential byte walk.
    """
    decoded = jnp.asarray(decoded, dtype=jnp.uint8)
    if n is None:
        n = int(decoded.shape[0])
    if n >= 2**31:
        raise ValueError("single-device OccIndex limited to 2^31-1 symbols; use parallel/")
    nb = max(1, -(-n // BIN))
    pad = nb * BIN - n
    bwt = jnp.pad(decoded[:n], (0, pad), constant_values=_PAD_SYMBOL)
    chunks = bwt.reshape(nb, BIN)
    # [nb, 6] per-bin symbol histogram; XLA fuses the compare+reduce
    per_bin = jnp.sum(
        chunks[:, :, None] == jnp.arange(VC_LEN, dtype=jnp.uint8)[None, None, :],
        axis=1,
        dtype=jnp.int32,
    )
    occ = jnp.concatenate(
        [jnp.zeros((1, VC_LEN), jnp.int32), jnp.cumsum(per_bin, axis=0, dtype=jnp.int32)]
    )
    totals = occ[-1]
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(totals, dtype=jnp.int32)]
    )
    return OccIndex(bwt=bwt, occ=occ, starts=starts, n=n)


def rank(index: OccIndex, sym: jax.Array, pos: jax.Array) -> jax.Array:
    """Batched rank: occurrences of ``sym[i]`` in ``bwt[0:pos[i]]``.

    occ-checkpoint row gather + masked in-bin window reduction — the exact
    analogue of the reference's fm_index[bin] seed + linear run decode
    (ref: src/rle_bwt.rs:204-244), with the run decode replaced by a
    fixed-width vectorized window sum.

    Both lookups are expressed as *row* gathers (``jnp.take(...,
    axis=0)``) plus elementwise one-hot selects: one contiguous row per
    query instead of a flat computed-index gather per element.
    """
    sym = jnp.asarray(sym, dtype=jnp.int32)
    pos = jnp.asarray(pos, dtype=jnp.int32)
    b = pos // BIN
    nb = index.bwt.shape[0] // BIN
    window = jnp.take(index.bwt.reshape(nb, BIN), b, axis=0)        # [B, BIN] u8
    occ_row = jnp.take(index.occ, b, axis=0)                        # [B, 6] i32
    sym_onehot = sym[:, None] == jnp.arange(VC_LEN, dtype=jnp.int32)[None, :]
    base = jnp.sum(occ_row * sym_onehot, axis=1, dtype=jnp.int32)
    in_range = jnp.arange(BIN, dtype=jnp.int32)[None, :] < (pos % BIN)[:, None]
    local = jnp.sum(
        (window == sym[:, None].astype(jnp.uint8)) & in_range, axis=1, dtype=jnp.int32
    )
    return base + local


def constrain_range(
    index: OccIndex, sym: jax.Array, lo: jax.Array, hi: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Batched LF step: [l, h) -> range of ``sym`` + k-mer
    (result-equivalent to ref: src/rle_bwt.rs:202-287)."""
    sym = jnp.asarray(sym, dtype=jnp.int32)
    both = rank(index, jnp.concatenate([sym, sym]), jnp.concatenate([lo, hi]))
    c = index.starts[sym]
    B = lo.shape[0]
    return c + both[:B], c + both[B:]


@functools.partial(jax.jit, static_argnames=("n", "cache_k"))
def _count_kmers_impl(bwt, occ, starts, n, kmers, lengths, cache=None, cache_k=0):
    index = OccIndex(bwt=bwt, occ=occ, starts=starts, n=n)
    B, K = kmers.shape
    lo = jnp.zeros(B, jnp.int32)
    hi = jnp.full(B, n, jnp.int32)

    t_start = 0
    if cache is not None and cache_k > 0 and K >= cache_k:
        # seed [lo, hi) from the precomputed range of the k-mer's last
        # cache_k symbols, then start the loop at step cache_k. The caller
        # guarantees every query in this batch has length >= cache_k (shorter
        # queries are routed through the uncached program).
        lo, hi = _cache_seed(cache, kmers, K, cache_k)
        t_start = cache_k

    def step(t, carry):
        lo, hi = carry
        col = K - 1 - t
        sym = kmers[:, col].astype(jnp.int32)
        # right-aligned k-mers: column is active while t < length
        active = t < lengths
        new_lo, new_hi = constrain_range(index, jnp.where(active, sym, 0), lo, hi)
        lo = jnp.where(active, new_lo, lo)
        hi = jnp.where(active, new_hi, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(t_start, K, step, (lo, hi))
    # n < 2^31 is guaranteed by build_occ_index; counts fit int32 exactly.
    # (BWTs past 2^31 symbols go through parallel/sharded_index wide mode.)
    return hi - lo


_CACHE_LEVEL_CHUNK = 6**8  # largest single-program level (compiler limit)


class KmerCache(NamedTuple):
    """Prefix-range cache as TWO flat [6^k] arrays (lo, hi) rather than one
    ``[6^k, 2]`` array, so no minor-dimension-2 intermediate is ever
    materialized."""

    lo: jax.Array   # i32 [VC_LEN**k]
    hi: jax.Array   # i32 [VC_LEN**k]

    @property
    def table(self) -> jax.Array:
        """[6^k, 2] host-friendly view (tests / inspection)."""
        return jnp.stack([self.lo, self.hi], axis=1)


def _cache_seed(cache, kmers, K, cache_k):
    """Seed [lo, hi) from the last ``cache_k`` symbols (two flat gathers)."""
    weights = VC_LEN ** (cache_k - 1 - jnp.arange(cache_k, dtype=jnp.int32))
    code = jnp.sum(
        kmers[:, K - cache_k :].astype(jnp.int32) * weights[None, :], axis=1
    )
    return jnp.take(cache.lo, code), jnp.take(cache.hi, code)


@functools.partial(jax.jit, static_argnames=("n", "size"))
def _cache_level_impl(bwt, occ, starts, n, lo, hi, *, size):
    """One cache level: extend every length-(l-1) range by each symbol."""
    index = OccIndex(bwt=bwt, occ=occ, starts=starts, n=n)
    sym = jnp.repeat(jnp.arange(VC_LEN, dtype=jnp.int32), size)
    new_lo, new_hi = constrain_range(index, sym, jnp.tile(lo, VC_LEN),
                                     jnp.tile(hi, VC_LEN))
    return new_lo, new_hi


@functools.partial(jax.jit, static_argnames=("n", "cache_k"))
def _cache_fused_impl(bwt, occ, starts, n, *, cache_k):
    """All cache levels in ONE program: fixed 6^k buffers + a fori_loop.

    Level l computes, for EVERY slot c, ``extend(T[c mod 6^(l-1)], digit)``
    — slots past 6^l hold garbage that later levels overwrite and never
    read (``rest < 6^(l-1)`` always lands in the valid region). The modest
    work inflation (k * 6^k ranks instead of sum 6^l) buys one compile
    instead of k — the per-level chain of programs is what made cache
    builds cost seconds per fresh BWT shape.
    """
    index = OccIndex(bwt=bwt, occ=occ, starts=starts, n=n)
    size = VC_LEN ** cache_k
    pows = jnp.asarray([VC_LEN ** i for i in range(cache_k)], jnp.int32)
    codes = jnp.arange(size, dtype=jnp.int32)
    lo = jnp.zeros(size, jnp.int32)
    hi = jnp.full(size, n, jnp.int32)

    def level(l, carry):
        lo, hi = carry
        p = pows[l - 1]
        sym = (codes // p) % VC_LEN
        rest = codes % p
        return constrain_range(index, sym, jnp.take(lo, rest),
                               jnp.take(hi, rest))

    lo, hi = jax.lax.fori_loop(1, cache_k + 1, level, (lo, hi))
    return lo, hi


def build_kmer_cache(bwt, occ, starts, n, cache_k: int) -> KmerCache:
    """Ranges of every length-``cache_k`` string over the 6-symbol alphabet
    (:class:`KmerCache`) — realizes the caching idea the reference sketches
    but never ships (ref: src/msbwt_core.rs:133-146). Up to 6^8 entries the
    whole build is ONE fused program (``_cache_fused_impl``); deeper caches
    build level by level, with levels past 6^8 entries run in fixed-size
    chunks (one giant program fails to compile).
    """
    if cache_k <= 8:
        return KmerCache(*_cache_fused_impl(bwt, occ, starts, n,
                                            cache_k=cache_k))
    # deep caches: fused program to level 8, then chunked levels on top
    lo, hi = _cache_fused_impl(bwt, occ, starts, n, cache_k=8)
    for level in range(9, cache_k + 1):
        size = VC_LEN ** (level - 1)
        if size <= _CACHE_LEVEL_CHUNK:
            lo, hi = _cache_level_impl(bwt, occ, starts, n, lo, hi, size=size)
        else:
            # chunk the previous level; each chunk expands to 6 chunks of the
            # new level interleaved by leading symbol: reorder afterwards.
            # new code = sym * size + rest, so chunk c of `rest` produces the
            # slice [sym*size + c*CH, sym*size + (c+1)*CH) for each sym.
            ch = _CACHE_LEVEL_CHUNK
            n_chunks = size // ch
            parts_lo, parts_hi = [], []
            for c in range(n_chunks):
                plo, phi = _cache_level_impl(
                    bwt, occ, starts, n,
                    jax.lax.dynamic_slice_in_dim(lo, c * ch, ch),
                    jax.lax.dynamic_slice_in_dim(hi, c * ch, ch),
                    size=ch,
                )
                parts_lo.append(plo.reshape(VC_LEN, ch))
                parts_hi.append(phi.reshape(VC_LEN, ch))
            # parts[c][s] holds codes [s*size + c*ch, s*size + (c+1)*ch)
            lo = jnp.stack(parts_lo, axis=1).reshape(VC_LEN * size)
            hi = jnp.stack(parts_hi, axis=1).reshape(VC_LEN * size)
    return KmerCache(lo, hi)


# compact the device->host result copy past this batch size: counts ride
# as u16 (half the bytes of the copy) with the true max carried in the last
# two words; an overflowing batch falls back to the full copy
_COMPACT_MIN_B = 1 << 16


@jax.jit
def _compact_counts_dev(counts):
    c16 = jnp.minimum(counts, 0xFFFF).astype(jnp.uint16)
    m = jnp.max(counts).astype(jnp.int32)
    tail = jnp.stack([m & 0xFFFF, m >> 16]).astype(jnp.uint16)
    return jnp.concatenate([c16, tail])


def fetch_counts(out) -> np.ndarray:
    """Copy device counts to host int64, halving the wire bytes when every
    count fits u16 (checked exactly via a carried max — lossless)."""
    import os

    if out.shape[0] < _COMPACT_MIN_B or os.environ.get("MSBWT_NO_COMPACT"):
        return np.asarray(out).astype(np.int64)
    buf = np.asarray(_compact_counts_dev(out))
    m = int(buf[-2]) | (int(buf[-1]) << 16)
    if m > 0xFFFF:  # rare: some count exceeds u16 — full-width copy
        return np.asarray(out).astype(np.int64)
    return buf[:-2].astype(np.int64)


def count_kmers(index: OccIndex, kmers, lengths=None, cache=None,
                cache_k: int = 0) -> np.ndarray:
    """Batched ``count_kmer``: ``[B, K]`` right-aligned int8 k-mers -> counts.

    A masked fixed-iteration loop replaces the reference's empty-range early
    exit (ref: src/msbwt_core.rs:151-153) — an empty range stays empty under
    further LF steps, so masking is exact. Pass a ``build_kmer_cache`` table
    to skip the first ``cache_k`` LF steps of every query.

    >>> from msbwt_jax.ops.alphabet import convert_stoi
    >>> from msbwt_jax.utils.oracle import naive_bwt
    >>> import numpy as np
    >>> idx = build_occ_index(convert_stoi(naive_bwt(["ACGT", "ACCA"])))
    >>> kmers = np.stack([convert_stoi("AC"), convert_stoi("GT")])
    >>> [int(c) for c in count_kmers(idx, kmers)]
    [2, 1]
    """
    from msbwt_jax.utils.checks import validate_kmers

    kmers = np.asarray(kmers, dtype=np.uint8)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    if not np.all(kmers < VC_LEN):
        raise AssertionError("k-mer symbols must be < 6")
    B, K = kmers.shape
    if lengths is None:
        lengths = np.full(B, K, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    validate_kmers(kmers, lengths)
    if cache is not None and cache_k > 0 and K >= cache_k:
        short = lengths < cache_k
        if short.any():  # rare path: too short for the cache seed
            out = np.empty(B, dtype=np.int64)
            out[short] = count_kmers(index, kmers[short], lengths[short])
            out[~short] = count_kmers(
                index, kmers[~short], lengths[~short], cache=cache, cache_k=cache_k
            )
            return out
    else:
        cache, cache_k = None, 0
    out = _count_kmers_impl(
        index.bwt, index.occ, index.starts, index.n,
        jnp.asarray(kmers), jnp.asarray(lengths),
        cache=cache, cache_k=cache_k,
    )
    return fetch_counts(out)
