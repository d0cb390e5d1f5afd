"""2-step FM index: backward search two symbols per round.

Queries on big indexes are gather-throughput bound, so the way up is
FEWER gathers per query. The k-step FM-index trick halves
the dependent LF rounds: precompute occurrence tables over symbol PAIRS
and consume two pattern symbols per rank.

Math (one fused double step): for a range end ``l`` and pattern symbols
``s1 s2`` (consumed right-to-left, ``s2`` first),

    l1 = C[s2] + rank_{s2}(l)
    l2 = C[s1] + rank_{s1}(l1)
       = C[s1] + D[s1][s2] + rank2_{(s2,s1)}(l)

where ``D[s1][s2] = #{j < C[s2] : BWT[j] = s1}`` is a 6x6 constant and
``rank2_{(a,b)}(l) = #{i < l : BWT[i] = a and BWT[LF(i)] = b}`` is rank
over the PAIR stream ``PS[i] = (BWT[i] << 3) | BWT[LF(i)]`` (proof: the
rows of the ``s2``-block below ``l1`` correspond order-preservingly via LF
to rows ``i < l`` with ``BWT[i] = s2``, and their BWT symbol is
``BWT[LF(i)]``).

Layout (default, 60 lanes / 240 B per 128-position bin): lanes 0..35 hold
occurrence checkpoints of the 36 VALID pair codes (dense ``s*6 + prev``
indexing), lanes 36..59 hold the 6 bit-planes x 4 lanes of in-bin 6-bit
pair codes packed FOUR qwords per lane. Big-index pair queries move
whole rows, so fewer row bytes mean fewer bytes per query.
``MSBWT_PAIR_ROW60=0`` restores
the legacy 128-lane row (512 B): occ checkpoints of the 48 shift-packed
codes ``(s << 3) | prev`` at lanes 0..47, plane-p qwords 4l..4l+3 in the
bytes of lane 48 + 4p + l — 6 planes x 16 qwords in lanes 48..71. Readers
infer the layout from the stored row width, so either table loads
anywhere. A pair rank is ONE row gather + bytewise XNOR/AND/popcount over
6 planes. The packing makes the odd-tail SINGLE-symbol rank free:
matching only the symbol-half planes counts positions with ``BWT[i] = s``
for any previous symbol. A 21-mer with a cache_k=8 seed costs 7 rounds
x 2 gathers = 14 gathers, vs 13 rounds x 2 = 26 through the single-step
table.

The pair stream needs LF for every position, computed positionally from
the occ checkpoints (no n-element sort; see ``_build_pair_stream``).

This is a pure QUERY-side structure: on-disk bytes and all other behavior
are untouched (reference hot loop being accelerated: src/rle_bwt.rs:202-287,
two pattern symbols per round).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from msbwt_jax.ops.alphabet import VC_LEN
from msbwt_jax.ops.rank import BIN, OccIndex, fetch_counts

PAIR_LANES = 48     # shift-packed codes (s << 3) | prev, s/prev in 0..5
_PAD_PAIR = 63      # never matches a real code (real max = 0b101101 = 45)

# valid 6-bit pair codes (prev < 6): 36 of the 48 shift-packed values
_VALID_CODES_NP = np.array(
    [(s << 3) | p for s in range(6) for p in range(6)], np.int32
)


def _row_lanes() -> int:
    """Pair-table row width in lanes. DEFAULT is the compact 60-lane row
    (240 B): lanes 0..35 = occ checkpoints of the 36 VALID pair codes
    (s*6 + prev), lanes 36..59 = the 6 planes x 4 packed-qword lanes
    (fewer bytes per gathered row than the legacy layout; neither is
    measured on the H100 yet). ``MSBWT_PAIR_ROW60=0`` restores the legacy
    128-lane row (512 B). Readers infer the layout
    from the stored row width, so either table loads anywhere."""
    import os

    return 128 if os.environ.get("MSBWT_PAIR_ROW60") == "0" else 60


class PairIndex(NamedTuple):
    """Device 2-step rank index."""

    table2: jax.Array   # i32 [NB, 60] (default; legacy [NB, 128]) — see _row_lanes
    starts: jax.Array   # i32 [VC_LEN + 1] C array
    dmat: jax.Array     # i32 [VC_LEN * VC_LEN]: D[s1*6 + s2] constants
    n: int


# strict prefix matrix: T[j, i] = 1 iff j < i, so (m @ T)[i] = #{j < i: m[j]}
_TRI_EXCL_NP = np.triu(np.ones((BIN, BIN), np.float32), 1)

# row-gather stream chunk cap (bins); read at trace time, patchable in tests
_ROWGATHER_CHUNK_BINS = 1 << 18


def _build_pair_stream(bwt_padded, occ, starts, *, n):
    """PS[i] = (BWT[i] << 3) | BWT[LF(i)] for i < n, else the pad code.

    LF is computed positionally from the occ checkpoints (no 500M-element
    sort): LF(i) = C[c] + occ[bin(i), c] + (exclusive in-bin rank of i
    among same-symbol positions), the in-bin rank via six bf16 matmuls
    with a strict-lower-triangular prefix matrix (0/1 operands, counts
    <= 128: exact). Default path: one n-element gather reads
    ``BWT[LF(i)]``.

    ``MSBWT_PAIR_FAST=1`` selects a row-gather variant (within one
    bin the LF targets of symbol-s positions are ONE contiguous run, so
    12 row gathers per bin + lane selects reconstruct every prev symbol),
    packing 4 symbols per i32 lane. Opt-in until both are timed on the
    H100 (ROADMAP 1.4)."""
    import os

    if os.environ.get("MSBWT_PAIR_FAST") == "1":
        return _build_pair_stream_rowgather(bwt_padded, occ, starts, n=n)
    return _build_pair_stream_flat(bwt_padded, occ, starts, n=n)


@functools.partial(jax.jit, static_argnames=("n",))
def _build_pair_stream_flat(bwt_padded, occ, starts, *, n):
    npad = bwt_padded.shape[0]
    NB = npad // BIN
    bins = bwt_padded.reshape(NB, BIN)
    tri = jnp.asarray(_TRI_EXCL_NP, jnp.bfloat16)
    excl = jnp.zeros((NB, BIN), jnp.float32)
    occ_base = jnp.zeros((NB, BIN), jnp.int32)
    for s in range(VC_LEN):
        m = (bins == s)
        e = jnp.dot(m.astype(jnp.bfloat16), tri,
                    preferred_element_type=jnp.float32)
        excl = jnp.where(m, e, excl)
        occ_base = jnp.where(m, occ[:NB, s][:, None], occ_base)
    sym = bins.astype(jnp.int32)
    lf = (
        jnp.take(starts, jnp.clip(sym, 0, VC_LEN))
        + occ_base
        + excl.astype(jnp.int32)
    ).reshape(-1)
    idx = jnp.arange(npad, dtype=jnp.int32)
    prev = jnp.take(bwt_padded, jnp.clip(lf, 0, npad - 1))
    ps = (bwt_padded.astype(jnp.int32) << 3) | prev.astype(jnp.int32)
    return jnp.where(idx < n, ps, _PAD_PAIR).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n",))
def _build_pair_stream_rowgather(bwt_padded, occ, starts, *, n):
    """Contiguous-run variant (see ``_build_pair_stream``): for the
    symbol-s positions of one bin, LF targets form ONE contiguous run, so
    two row gathers per (bin, symbol) + lane ``take_along_axis`` read all
    their prev symbols. All sliced/gathered arrays are i32 full-width
    [*, 128] rows."""
    npad = bwt_padded.shape[0]
    NB = npad // BIN
    bins = bwt_padded.reshape(NB, BIN)
    tri = jnp.asarray(_TRI_EXCL_NP, jnp.bfloat16)

    bins_i32 = bins.astype(jnp.int32)  # [NB, 128] — 2 GB at 505M

    # chunk over bins so the [chunk, 128] i32 temporaries stay ~100 MB
    CB = min(_ROWGATHER_CHUNK_BINS, NB)
    nc = -(-NB // CB)
    pad_rows = nc * CB - NB
    bins_p = jnp.pad(bins_i32, ((0, pad_rows), (0, 0)), constant_values=7)
    occ_p = jnp.pad(occ[:NB], ((0, pad_rows), (0, 0)))

    def chunk(c, ps):
        cb = jax.lax.dynamic_slice(bins_p, (c * CB, 0), (CB, BIN))
        co = jax.lax.dynamic_slice(occ_p, (c * CB, 0), (CB, VC_LEN))
        prev = jnp.zeros((CB, BIN), jnp.int32)
        for s in range(VC_LEN):
            m = (cb == s)
            e = jnp.dot(m.astype(jnp.bfloat16), tri,
                        preferred_element_type=jnp.float32).astype(jnp.int32)
            g = starts[s] + co[:, s]                     # [CB] run starts
            r0 = jnp.clip(g // BIN, 0, NB - 1)
            w0 = jnp.take(bins_i32, r0, axis=0)          # [CB, 128]
            w1 = jnp.take(bins_i32, jnp.clip(r0 + 1, 0, NB - 1), axis=0)
            off = (g % BIN)[:, None] + e                 # in [0, 256)
            lo = jnp.take_along_axis(w0, jnp.clip(off, 0, BIN - 1), axis=1)
            hi = jnp.take_along_axis(
                w1, jnp.clip(off - BIN, 0, BIN - 1), axis=1
            )
            val = jnp.where(off < BIN, lo, hi)
            prev = jnp.where(m, val, prev)
        cp = (cb << 3) | prev
        return jax.lax.dynamic_update_slice(ps, cp, (c * CB, 0))

    ps = jax.lax.fori_loop(
        0, nc, chunk, jnp.zeros((nc * CB, BIN), jnp.int32)
    )[:NB].reshape(-1)
    idx = jnp.arange(npad, dtype=jnp.int32)
    return jnp.where(idx < n, ps, _PAD_PAIR).astype(jnp.int32)


def _pair_weights() -> np.ndarray:
    """[6, 128, 128] f32: plane-p weights mapping in-bin position i to qword
    lane 16p + i//8 with weight 2^(i%8) (byte sums <= 255: bf16-exact)."""
    w = np.zeros((6, 128, 128), np.float32)
    for plane in range(6):
        for i in range(128):
            w[plane, i, 16 * plane + i // 8] = float(1 << (i % 8))
    return w


_PAIR_W = _pair_weights()


@functools.partial(jax.jit, static_argnames=("lanes",))
def _build_pair_table(ps, *, lanes: int = 128):
    """Pair-rank table rows — a rank is ONE row gather + bytewise
    XNOR/AND/popcount over 6 planes, so at big table sizes (the gather is
    BANDWIDTH-bound) row bytes are the cost.

    ``lanes=128`` (legacy, 512 B rows): occ checkpoints of the 48 shift-
    packed codes at lanes 0..47; the 6 bit-planes' qwords packed FOUR per
    i32 lane at 48..71 (plane p, lane 48+4p+l holds qwords 4l..4l+3 in
    bytes 0..3 — qword values are <= 255, and the bytewise decode works on
    the packed words). ``lanes=60`` (compact, 240 B rows): occ of only the
    36 VALID codes (lane s*6 + prev) at 0..35; planes at 36..59."""
    npad = ps.shape[0]
    NB = npad // BIN
    bins = ps.reshape(NB, BIN)
    if lanes == 60:
        pair_ids = jnp.asarray(_VALID_CODES_NP)
        occ_lanes, plane_base = 36, 36
    else:
        pair_ids = jnp.arange(PAIR_LANES, dtype=jnp.int32)
        occ_lanes, plane_base = PAIR_LANES, 48
    per_bin = jnp.sum(
        bins[:, :, None] == pair_ids[None, None, :], axis=1, dtype=jnp.int32
    )  # [NB, occ_lanes]
    occ2 = jnp.cumsum(per_bin, axis=0, dtype=jnp.int32) - per_bin
    wq = jnp.asarray(_PAIR_W, jnp.bfloat16)
    acc = jnp.zeros((NB, 128), jnp.float32)
    for p in range(6):
        bits = ((bins >> p) & 1).astype(jnp.bfloat16)
        acc = acc + jnp.dot(bits, wq[p], preferred_element_type=jnp.float32)
    planes = acc.astype(jnp.int32)  # matmul lanes: plane p qword j at 16p+j
    packed = (
        planes[:, 0::4]
        | (planes[:, 1::4] << 8)
        | (planes[:, 2::4] << 16)
        | (planes[:, 3::4] << 24)
    )[:, :24]  # plane p lane l at 4p+l
    row = jnp.zeros((NB, lanes), jnp.int32)
    row = row.at[:, :occ_lanes].set(occ2)
    row = row.at[:, plane_base : plane_base + 24].set(packed)
    return row


@jax.jit
def _build_dmat(bwt_padded, occ, starts):
    """D[s1][s2] = occurrences of s1 strictly before C[s2], flattened [36].
    Six 128-byte window gathers + occ rows — stays on device, so the
    decoded BWT never crosses to the host."""
    nb = bwt_padded.shape[0] // BIN
    c = starts[:VC_LEN]
    b = jnp.minimum(c // BIN, nb - 1)
    r = c - b * BIN
    win = jnp.take(bwt_padded.reshape(nb, BIN), b, axis=0)     # [6 s2, BIN]
    occ_rows = jnp.take(occ, b, axis=0)                        # [6 s2, 6 s1]
    in_range = jnp.arange(BIN, dtype=jnp.int32)[None, :] < r[:, None]
    s1 = jnp.arange(VC_LEN, dtype=jnp.uint8)
    local = jnp.sum(
        (win[:, :, None] == s1[None, None, :]) & in_range[:, :, None],
        axis=1, dtype=jnp.int32,
    )                                                          # [6 s2, 6 s1]
    return (occ_rows + local).T.reshape(-1)                    # D[s1*6 + s2]


def build_pair_index(index: OccIndex) -> PairIndex:
    """Derive the 2-step index from the standard occ index (one-time cost:
    the occ-checkpoint LF pass + one table pass — 0.1 s per 10M symbols).

    >>> from msbwt_jax.ops.alphabet import convert_stoi
    >>> from msbwt_jax.ops.rank import build_occ_index
    >>> from msbwt_jax.utils.oracle import naive_bwt
    >>> idx = build_occ_index(convert_stoi(naive_bwt(["ACGT", "TGCA"])))
    >>> pidx = build_pair_index(idx)
    >>> [int(c) for c in count_kmers_pair(pidx, convert_stoi("GCA"))]
    [1]
    """
    ps = _build_pair_stream(index.bwt, index.occ, index.starts, n=index.n)
    table2 = _build_pair_table(ps, lanes=_row_lanes())
    dmat = _build_dmat(index.bwt, index.occ, index.starts)
    return PairIndex(
        table2=table2, starts=index.starts, dmat=dmat, n=index.n,
    )


def _rows_of(table2, pos):
    """The one gather per rank: [B] positions -> [B, 128] bin rows."""
    return jnp.take(table2, pos // BIN, axis=0)


def _decode_rank(row, pos, code, n_planes):
    """Rank from an already-gathered row. ``n_planes=6`` matches the full
    6-bit pair code; ``n_planes=3`` matches only the BWT-symbol planes
    (bits 3..5), i.e. single-symbol rank with any previous symbol. The row
    layout (legacy 128-lane / compact 60-lane) is inferred from the row
    width at trace time."""
    B = code.shape[0]
    compact = row.shape[1] == 60
    occ_lanes = 36 if compact else PAIR_LANES
    plane_base = 36 if compact else 48
    if n_planes == 6:
        if compact:
            # valid-code lane: (s << 3 | prev) -> s*6 + prev
            occ_lane = (code >> 3) * 6 + (code & 7)
        else:
            occ_lane = code
        occ_oh = (
            occ_lane[:, None] == jnp.arange(occ_lanes, dtype=jnp.int32)[None, :]
        )
        occ_base = jnp.sum(
            jnp.where(occ_oh, row[:, :occ_lanes], 0), axis=1, dtype=jnp.int32
        )
        planes = range(6)
    else:
        # single symbol s = code: occ base = sum of its pair lanes (compact:
        # lanes s*6 .. s*6+5; legacy: codes (s<<3)|0 .. |7 — prev >= 6 lanes
        # are always zero)
        lane_ids = jnp.arange(occ_lanes, dtype=jnp.int32)[None, :]
        lane_sym = lane_ids // 6 if compact else lane_ids >> 3
        occ_base = jnp.sum(
            jnp.where(lane_sym == code[:, None], row[:, :occ_lanes], 0),
            axis=1, dtype=jnp.int32,
        )
        code = code << 3  # align the symbol bits with planes 3..5
        planes = range(3, 6)
    # packed decode: 4 qwords per i32 lane; the XNOR/AND trick is bytewise-
    # safe because sp is 0x00000000 or 0xFFFFFFFF (all bytes identical)
    match = jnp.full((B, 4), -1, jnp.int32)
    for p in planes:
        words = row[:, plane_base + 4 * p : plane_base + 4 * p + 4]
        sp = -((code >> p) & 1)
        match = match & ~(words ^ sp[:, None])
    b = pos // BIN
    r = (pos - b * BIN)[:, None]
    lane4 = jnp.arange(4, dtype=jnp.int32)[None, :]
    # per-byte prefix masks, assembled into one i32 per lane: byte b of
    # lane l covers qword 4l+b = positions 32l+8b .. +7
    pmask = jnp.zeros((B, 4), jnp.int32)
    for byte in range(4):
        sh = jnp.clip(r - (32 * lane4 + 8 * byte), 0, 8)
        pmask = pmask | (((jnp.int32(1) << sh) - 1) << (8 * byte))
    local = jnp.sum(
        jax.lax.population_count(match & pmask), axis=1, dtype=jnp.int32
    )
    return occ_base + local


@functools.partial(jax.jit, static_argnames=("n", "cache_k"))
def _count_kmers_pair_impl(table2, starts, dflat, n, kmers, lengths,
                           cache=None, cache_k=0):
    """Backward search consuming TWO symbols per round; an odd tail consumes
    one symbol from the same gathered row via the 3-plane decode."""
    B, K = kmers.shape
    lo = jnp.zeros(B, jnp.int32)
    hi = jnp.full(B, n, jnp.int32)

    t_start = 0
    if cache is not None and cache_k > 0 and K >= cache_k:
        from msbwt_jax.ops.rank import _cache_seed

        lo, hi = _cache_seed(cache, kmers, K, cache_k)
        t_start = cache_k

    def pair_step(t, carry):
        lo, hi = carry
        col2 = K - 1 - t
        s2 = jax.lax.dynamic_slice_in_dim(kmers, col2, 1, axis=1)[:, 0]
        s1 = jax.lax.dynamic_slice_in_dim(
            kmers, jnp.maximum(col2 - 1, 0), 1, axis=1
        )[:, 0]
        s2 = s2.astype(jnp.int32)
        s1 = s1.astype(jnp.int32)
        both = (t + 1) < lengths          # two symbols remain
        one = (t < lengths) & jnp.logical_not(both)
        s2m = jnp.where(t < lengths, s2, 0)
        s1m = jnp.where(both, s1, 0)
        code2 = (s2m << 3) | s1m          # PS code (BWT=s2, prev=s1)
        row_lo = _rows_of(table2, lo)
        row_hi = _rows_of(table2, hi)
        d = starts[s1m] + dflat[s1m * VC_LEN + s2m]
        new_lo2 = d + _decode_rank(row_lo, lo, code2, 6)
        new_hi2 = d + _decode_rank(row_hi, hi, code2, 6)
        new_lo1 = starts[s2m] + _decode_rank(row_lo, lo, s2m, 3)
        new_hi1 = starts[s2m] + _decode_rank(row_hi, hi, s2m, 3)
        lo = jnp.where(both, new_lo2, jnp.where(one, new_lo1, lo))
        hi = jnp.where(both, new_hi2, jnp.where(one, new_hi1, hi))
        return lo, hi

    n_rounds = max(-(-(K - t_start) // 2), 0)
    lo, hi = jax.lax.fori_loop(
        0, n_rounds,
        lambda r, c: pair_step(t_start + 2 * r, c),
        (lo, hi),
    )
    return hi - lo


def count_kmers_pair(pidx: PairIndex, kmers, lengths=None, cache=None,
                     cache_k: int = 0) -> np.ndarray:
    """Batched ``count_kmer`` through the 2-step index (results identical to
    ``ops.rank.count_kmers`` — pinned by tests)."""
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
            out[short] = count_kmers_pair(pidx, kmers[short], lengths[short])
            out[~short] = count_kmers_pair(
                pidx, kmers[~short], lengths[~short], cache=cache,
                cache_k=cache_k,
            )
            return out
    else:
        cache, cache_k = None, 0
    out = _count_kmers_pair_impl(
        pidx.table2, pidx.starts, pidx.dmat, pidx.n,
        jnp.asarray(kmers), jnp.asarray(lengths),
        cache=cache, cache_k=cache_k,
    )
    return fetch_counts(out)
