"""Read recovery: the MSBWT is a lossless archive of the read collection.

Read ``i`` (in lexicographic order — the order sorted construction stores
them) is recovered by LF-walking backward from terminator rotation ``i``
(BWT rows 0..n_strings-1 are the ``$`` rotations) until the walk closes the
cycle at ``$``; the symbols visited are the read right-to-left. The
reference keeps this implicit in its tests (the same walk recovers lengths);
here it is a batched device program: all requested reads walk together, one
packed-rank gather per step, masked after each read's terminator.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from msbwt_jax.ops.rank import OccIndex


@functools.partial(jax.jit, static_argnames=("l_max",))
def _extract_impl(bwt, table, starts, ids, l_max):
    from msbwt_jax.ops.packed_rank import rank_packed

    B = ids.shape[0]
    pos = ids.astype(jnp.int32)
    out = jnp.zeros((B, l_max), jnp.uint8)
    done = jnp.zeros(B, bool)

    def step(t, carry):
        pos, out, done = carry
        sym = jnp.take(bwt, pos).astype(jnp.int32)
        hit_end = sym == 0
        keep = jnp.logical_not(done) & jnp.logical_not(hit_end)
        # symbols arrive right-to-left: column l_max-1-t, compacted later.
        # The loop runs one extra step so length-l_max reads still observe
        # their terminator; that step writes nothing (keep is False).
        col = jnp.clip(l_max - 1 - t, 0, l_max - 1)
        out = out.at[:, col].set(
            jnp.where(keep, sym.astype(jnp.uint8), out[:, col])
        )
        s = jnp.where(keep, sym, 0)
        new_pos = starts[s] + rank_packed(table, s, pos)
        pos = jnp.where(keep, new_pos, pos)
        done = done | hit_end
        return pos, out, done

    pos, out, done = jax.lax.fori_loop(0, l_max + 1, step, (pos, out, done))
    return out, done


def extract_reads(index: OccIndex, ids, n_strings: int, l_max: int | None = None):
    """Recover reads by index from a BWT. Returns a list of int-encoded reads
    (uint8 arrays, no terminator), in the order of ``ids``.

    ``ids`` index the terminator rotations (0..n_strings-1) — for a sorted
    build that is the lexicographic read order. ``l_max`` bounds the walk
    (defaults to the longest read, recovered from the BWT itself).

    >>> import numpy as np
    >>> from msbwt_jax.models.dynamic import DynamicBWT
    >>> from msbwt_jax.ops.alphabet import convert_itos
    >>> from msbwt_jax.ops.rank import build_occ_index
    >>> bwt = DynamicBWT()
    >>> bwt.insert_strings(["GATTACA", "CAT"], sorted=True)
    >>> idx = build_occ_index(np.asarray(bwt.to_vec()))
    >>> [convert_itos(r) for r in extract_reads(idx, [0, 1], 2)]
    ['CAT', 'GATTACA']
    """
    from msbwt_jax.ops.bcr import read_lengths_from_bwt
    from msbwt_jax.ops.packed_rank import pack_index

    ids = np.asarray(ids, dtype=np.int32)
    if ids.size == 0:
        return []
    if not np.all((ids >= 0) & (ids < n_strings)):
        raise ValueError(f"read ids must be in [0, {n_strings})")
    if l_max is None:
        l_max = int(read_lengths_from_bwt(index, n_strings).max())
    pidx = pack_index(index)
    out, done = _extract_impl(
        index.bwt, pidx.table, pidx.starts, jnp.asarray(ids), max(int(l_max), 1)
    )
    if not bool(np.asarray(done).all()):
        raise ValueError(f"l_max={l_max} too small: some reads did not close")
    out = np.asarray(out)
    return [row[row != 0] for row in out]


@functools.partial(jax.jit, static_argnames=("l_max",))
def _locate_walk_impl(bwt, table, starts, pos, n_strings, l_max):
    """LF-walk every BWT row in ``pos`` backward until it enters the
    terminator block (rows < n_strings). Returns (read_id, offset): the
    terminator row IS the read's lexicographic id, and a row whose suffix
    starts at read offset j takes j+1 steps to reach it."""
    from msbwt_jax.ops.packed_rank import rank_packed

    steps = jnp.zeros(pos.shape, jnp.int32)

    def step(t, carry):
        pos, steps = carry
        active = pos >= n_strings
        sym = jnp.take(bwt, pos).astype(jnp.int32)
        s = jnp.where(active, sym, 0)
        new_pos = starts[s] + rank_packed(table, s, pos)
        pos = jnp.where(active, new_pos, pos)
        steps = steps + active.astype(jnp.int32)
        return pos, steps

    pos, steps = jax.lax.fori_loop(0, l_max + 1, step, (pos, steps))
    return pos, steps - 1


def locate_kmers(index: OccIndex, kmers, n_strings: int, lengths=None,
                 l_max: int | None = None):
    """Map every k-mer occurrence to ``(query, read_id, offset)`` — the
    original msbwt's ``findReadsMatchingSeq``, batched: one backward
    search gives each query's BWT row range, then ALL hit rows LF-walk to
    their terminators together (one packed-rank gather per step).

    Returns three equal-length int arrays ``(query_idx, read_id, offset)``
    — read ids are lexicographic (``extract_reads``'s id space), offsets
    are 0-based match starts within the read. The reference crate stops at
    ``count_kmer``; hit localization is new surface (the walk machinery
    mirrors its test-only recovery loops, ref: src/dynamic_bwt.rs:393-430).
    Positions are int32 (single-chip indexes, < 2^31 symbols); past that,
    queries go through the sharded wide-position index, which does not
    expose locate.

    >>> import numpy as np
    >>> from msbwt_jax.models.dynamic import DynamicBWT
    >>> from msbwt_jax.ops.alphabet import convert_stoi
    >>> from msbwt_jax.ops.rank import build_occ_index
    >>> bwt = DynamicBWT()
    >>> bwt.insert_strings(["ACGTA", "GGACG"], sorted=True)
    >>> idx = build_occ_index(np.asarray(bwt.to_vec()))
    >>> q, r, o = locate_kmers(idx, [convert_stoi("ACG")], 2)
    >>> sorted(zip(r.tolist(), o.tolist()))   # in read 0 @0, read 1 @2
    [(0, 0), (1, 2)]
    """
    from msbwt_jax.ops.bcr import read_lengths_from_bwt
    from msbwt_jax.ops.packed_rank import (
        _kmer_ranges_packed_impl,
        pack_index,
    )

    kmers = np.asarray(kmers, dtype=np.uint8)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    B, K = kmers.shape
    if lengths is None:
        lengths = np.full(B, K, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    pidx = pack_index(index)
    lo, hi = _kmer_ranges_packed_impl(
        pidx.table, pidx.starts, pidx.n,
        jnp.asarray(kmers), jnp.asarray(lengths),
    )
    lo = np.asarray(lo)
    counts = np.asarray(hi) - lo
    empty = np.zeros(0, np.int32)
    if counts.sum() == 0:
        return empty, empty, empty
    # flatten every range [lo_i, hi_i) into one walk batch
    qidx = np.repeat(np.arange(B, dtype=np.int32), counts)
    within = np.arange(qidx.size, dtype=np.int32) - np.repeat(
        np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.int32), counts
    )
    pos = np.repeat(lo, counts).astype(np.int32) + within
    if l_max is None:
        l_max = int(read_lengths_from_bwt(index, n_strings).max())
    # pad the walk batch to a power of two: hit counts vary per call, and
    # each distinct batch shape would otherwise recompile the walk (pad
    # rows start at row 0 < n_strings, i.e. instantly inactive)
    H = pos.size
    pos_p = np.zeros(max(1 << (H - 1).bit_length(), 16), np.int32)
    pos_p[:H] = pos
    rid, off = _locate_walk_impl(
        index.bwt, pidx.table, pidx.starts, jnp.asarray(pos_p),
        jnp.int32(n_strings), max(int(l_max), 1),
    )
    return qidx, np.asarray(rid)[:H], np.asarray(off)[:H]
