"""Packed single-gather rank: occ checkpoints + bit-plane words in one row.

The baseline rank (``ops.rank.rank``) issues two row gathers per rank — a
128-byte symbol window plus an occurrence-table row. Random row gathers are
the cost floor of the whole query path (ref hot loop:
src/rle_bwt.rs:202-287), so this layout halves them: each 128-position bin
is one 32-lane int32 row

  lanes 0..5   occ[sym]  — occurrences of sym strictly before the bin
  lanes 8+4p+j bit-plane p (of 3) word j (of 4): bit k of word j = plane-p
               bit of the symbol at bin position 32 j + k

and a rank needs ONE gather of that row; the in-bin count becomes XOR +
AND + popcount over 12 words (VPU, fused by XLA). PAD symbol 7 has all
three plane bits set and can never equal a queried symbol in 0..5, so tail
padding needs no masking. Row width 32 lanes (128 B) keeps the gather the
same size as one baseline window row while replacing both gathers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from msbwt_jax.ops.alphabet import VC_LEN
from msbwt_jax.ops.rank import BIN, OccIndex
from msbwt_jax.ops.rank import fetch_counts as rank_fetch_counts

ROW = 32  # int32 lanes per packed bin row


class PackedOccIndex(NamedTuple):
    """Device rank index: one 128-byte row per 128-symbol bin."""

    table: jax.Array    # int32 [nb, ROW]
    starts: jax.Array   # int32 [VC_LEN + 1]
    n: int              # BWT length (static)

    @property
    def counts(self) -> jax.Array:
        d = jnp.diff(self.starts)
        return d


def pack_index(index: OccIndex) -> PackedOccIndex:
    """Build the packed table from a standard ``OccIndex`` (device, one pass).

    The table carries one extra terminal row (occ lanes = totals, plane
    words = 0): a rank at pos == n with n a multiple of BIN indexes bin
    ``n // BIN``, which only exists as a boundary row — without it the row
    gather goes out of range (jnp.take fill mode) and the rank is garbage.

    >>> from msbwt_jax.ops.alphabet import convert_stoi
    >>> from msbwt_jax.ops.rank import build_occ_index
    >>> from msbwt_jax.utils.oracle import naive_bwt
    >>> idx = build_occ_index(convert_stoi(naive_bwt(["ACGT", "TGCA"])))
    >>> pidx = pack_index(idx)
    >>> int(count_kmers_packed(pidx, convert_stoi("ACGT"))[0])
    1
    """
    nb = index.bwt.shape[0] // BIN
    syms = index.bwt.reshape(nb, BIN).astype(jnp.int32)  # PAD=7 has all bits set
    w = syms.reshape(nb, 4, 32)
    k = jnp.arange(32, dtype=jnp.int32)
    planes = []
    for p in range(3):
        bits = (w >> p) & 1
        words = jnp.sum(bits << k[None, None, :], axis=2, dtype=jnp.int32)  # [nb,4]
        planes.append(words)
    table = jnp.zeros((nb + 1, ROW), jnp.int32)
    table = table.at[:, :VC_LEN].set(index.occ[: nb + 1])
    table = table.at[:nb, 8:12].set(planes[0])
    table = table.at[:nb, 12:16].set(planes[1])
    table = table.at[:nb, 16:20].set(planes[2])
    return PackedOccIndex(table=table, starts=index.starts, n=index.n)


def rank_packed(table: jax.Array, sym: jax.Array, pos: jax.Array) -> jax.Array:
    """Batched rank via one packed-row gather per query.

    ``sym`` [B] i32 in 0..5, ``pos`` [B] i32. Returns occurrences of sym in
    bwt[0:pos].
    """
    b = pos // BIN
    r = pos - b * BIN  # in-bin position, 0..127
    row = jnp.take(table, b, axis=0)  # [B, ROW] — the single gather
    occ_base = jnp.sum(
        jnp.where(
            jnp.arange(VC_LEN, dtype=jnp.int32)[None, :] == sym[:, None],
            row[:, :VC_LEN],
            0,
        ),
        axis=1,
        dtype=jnp.int32,
    )
    # plane-match words: ~(plane_p ^ broadcast(bit_p(sym))) AND-ed over planes
    match = jnp.full((sym.shape[0], 4), -1, jnp.int32)
    for p in range(3):
        words = row[:, 8 + 4 * p : 12 + 4 * p]
        sp = -((sym >> p) & 1)  # 0 -> 0x0, 1 -> 0xFFFFFFFF
        match = match & ~(words ^ sp[:, None])
    # positions < r mask per word j: covers positions 32j .. 32j+31
    j32 = jnp.arange(4, dtype=jnp.int32)[None, :] * 32
    shift = jnp.clip(r[:, None] - j32, 0, 32)
    # (1 << shift) - 1 without a 1<<32 overflow: full word when shift == 32
    pmask = jnp.where(
        shift >= 32,
        jnp.int32(-1),
        (jnp.int32(1) << jnp.minimum(shift, 31)) - jnp.int32(1),
    )
    local = jnp.sum(
        jax.lax.population_count(match & pmask), axis=1, dtype=jnp.int32
    )
    return occ_base + local


@functools.partial(jax.jit, static_argnames=("n", "cache_k"))
def _kmer_ranges_packed_impl(table, starts, n, kmers, lengths, cache=None,
                             cache_k=0):
    """Backward-search every k-mer to its BWT row range ``[lo, hi)``
    (``count == hi - lo``; the range rows are the suffix positions a
    locate walk starts from)."""
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
        both = rank_packed(
            table, jnp.concatenate([s, s]), jnp.concatenate([lo, hi])
        )
        c = starts[s]
        new_lo, new_hi = c + both[:B], c + both[B:]
        lo = jnp.where(active, new_lo, lo)
        hi = jnp.where(active, new_hi, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(t_start, K, step, (lo, hi))
    return lo, hi


@functools.partial(jax.jit, static_argnames=("n", "cache_k"))
def _count_kmers_packed_impl(table, starts, n, kmers, lengths, cache=None,
                             cache_k=0):
    lo, hi = _kmer_ranges_packed_impl(table, starts, n, kmers, lengths,
                                      cache=cache, cache_k=cache_k)
    return hi - lo


def count_kmers_packed(index: PackedOccIndex, kmers, lengths=None, cache=None,
                       cache_k: int = 0) -> np.ndarray:
    """Batched ``count_kmer`` over the packed index (result-equivalent to
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
            out[short] = count_kmers_packed(index, kmers[short], lengths[short])
            out[~short] = count_kmers_packed(
                index, kmers[~short], lengths[~short], cache=cache, cache_k=cache_k
            )
            return out
    else:
        cache, cache_k = None, 0
    out = _count_kmers_packed_impl(
        index.table, index.starts, index.n,
        jnp.asarray(kmers), jnp.asarray(lengths), cache=cache, cache_k=cache_k,
    )
    return rank_fetch_counts(out)
