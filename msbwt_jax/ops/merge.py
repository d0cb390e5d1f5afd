"""Holt–McMillan interleave merge as a device program.

The reference carries a host-side pairwise merge used only by tests
(ref: src/bwt_util.rs:21-141). Here the merge is a production op: it is the
cross-shard combiner for distributed construction (SURVEY.md §5
"long-context" analogue) and the engine behind merging externally-built BWTs.

One refinement round (ref semantics: src/bwt_util.rs:21-55) is, in array
form: reconstruct the merged symbol stream from the current interleave, then
stable-counting-sort the interleave bits by symbol. A stable argsort over the
6-symbol alphabet expresses the counting sort as one XLA sort + gather; the
fixpoint loop (ref: src/bwt_util.rs:120-124) becomes ``lax.while_loop`` with
an any-changed flag. Convergence takes at most max-rotation-period rounds.

Ties (equal cyclic rotations across the two inputs) stay in bwt0-before-bwt1
order, matching the reference's stable refinement.

Two formulations of the same fixpoint live here:

* ``_merge_impl`` — the literal H-M refinement (one symbol of rotation
  depth per round; at most max-rotation-period rounds, e.g. ~101 for
  100 bp reads).
* ``_doubling_merge_impl`` — rank prefix-doubling over the union of
  rotations (Manber–Myers applied to the D-way merge): round r sorts by
  ``(rank_k, rank_k ∘ psi^k)`` which doubles the resolved rotation depth,
  so convergence takes ceil(log2 max-period) + 1 rounds (~8 for 100 bp)
  and merges ALL D sources in one run instead of a log2(D)-level pairwise
  tree. Each source's psi (successor-rotation map, = LF^-1) is one stable
  counting sort, and both sorts share a single device ``lax.sort`` over a
  (source, symbol) combined key. Ties (identical rotations) keep the
  source-major input order — the same stable order H-M converges to.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("n0", "n1", "wide"))
def _merge_impl(bwt0, bwt1, n0, n1, wide=False):
    n = n0 + n1
    # positions go int64 ("wide") once the merged size can pass 2^31 —
    # the reference's counts are u64 throughout (ref: src/msbwt_core.rs:124)
    pos_dtype = jnp.int64 if wide else jnp.int32
    idx = jnp.arange(n, dtype=pos_dtype)

    def gather_syms(interleave):
        c0 = jnp.cumsum(interleave.astype(pos_dtype)) - interleave.astype(pos_dtype)
        pos0 = jnp.clip(c0, 0, n0 - 1)
        pos1 = jnp.clip(idx - c0, 0, n1 - 1)
        return jnp.where(interleave, bwt0[pos0], bwt1[pos1])

    def refine(interleave):
        syms = gather_syms(interleave)
        perm = jnp.argsort(syms, stable=True)
        return interleave[perm]

    init = idx < n0

    def cond(carry):
        cur, nxt = carry
        return jnp.any(cur != nxt)

    def body(carry):
        _, nxt = carry
        return nxt, refine(nxt)

    _, final = jax.lax.while_loop(cond, body, (init, refine(init)))
    return gather_syms(final), final


@functools.partial(jax.jit, static_argnames=("n", "wide"))
def _doubling_merge_impl(syms, src, *, n, wide=False):
    """D-way merge by rank prefix-doubling (see module docstring).

    ``syms``: [n] u8 source-major concatenation of the decoded BWTs.
    ``src``:  [n] i32 source id per element.
    Returns (merged symbols [n] u8, source id per merged position [n] i32).

    Rows of a BWT are its sorted rotations; row r's rotation spells
    ``F[r], F[psi(r)], F[psi^2(r)], ...`` where F = sorted symbols and
    psi = LF^-1 = the stable counting-sort permutation of the BWT
    (ref LF: src/rle_bwt.rs:202-287 uses the inverse walk). Sorting the
    union of all sources' rows by that symbol stream IS the merge
    (ref pairwise semantics: src/bwt_util.rs:21-141); rank doubling
    resolves 2^r symbols after r rounds.
    """
    pos_dtype = jnp.int64 if wide else jnp.int32
    idx = jnp.arange(n, dtype=pos_dtype)

    # one stable sort of (source, symbol) yields, per source block:
    #   psi  — the counting-sort permutation (global element indices)
    #   F    — the sorted symbols = each row's first rotation symbol
    combo = src.astype(pos_dtype) * 8 + syms.astype(pos_dtype)
    combo_sorted, psi = jax.lax.sort((combo, idx), num_keys=1, is_stable=True)
    fsym = combo_sorted % 8  # element-space: concatenation is source-major

    def ranks_of(k1, k2):
        # stable sort of element-space keys: ties keep source-major input
        # order, the same tie order the H-M refinement preserves
        k1s, k2s, perm = jax.lax.sort((k1, k2, idx), num_keys=2,
                                      is_stable=True)
        neq = (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])
        r_sorted = jnp.concatenate(
            [jnp.zeros(1, pos_dtype),
             jnp.cumsum(neq.astype(pos_dtype))]
        )
        rank = jnp.zeros(n, pos_dtype).at[perm].set(r_sorted, mode="drop")
        return rank, perm

    rank0, perm0 = ranks_of(fsym, jnp.zeros_like(fsym))

    def cond(carry):
        return carry[3]

    def body(carry):
        rank, _, succ, _ = carry
        rank_ahead = jnp.take(rank, succ)
        new_rank, new_perm = ranks_of(rank, rank_ahead)
        # fixpoint: no split this round => the partition is shift-stable
        # and no later round can split it either (congruence argument)
        changed = jnp.any(new_rank != rank)
        return new_rank, new_perm, jnp.take(succ, succ), changed

    _, perm, _, _ = jax.lax.while_loop(
        cond, body, (rank0, perm0, psi, jnp.bool_(True))
    )
    return jnp.take(syms, perm), jnp.take(src, perm)


def _wide(n0: int, n1: int, force_wide: bool) -> bool:
    return force_wide or (n0 + n1) >= 2**31


def pairwise_bwt_merge(bwt0, bwt1, force_wide: bool = False) -> np.ndarray:
    """Merge two decoded BWTs into the BWT of the union (device fixpoint).

    Result-equivalent to the reference's ``pairwise_bwt_merge``
    (ref: src/bwt_util.rs:108-141). Positions switch to int64 automatically
    past 2^31 merged symbols; ``force_wide`` exercises that path on small
    data for tests.

    >>> from msbwt_jax.ops.alphabet import convert_itos, convert_stoi
    >>> from msbwt_jax.utils.oracle import naive_bwt
    >>> a = convert_stoi(naive_bwt(["ACGT"]))
    >>> b = convert_stoi(naive_bwt(["TGCA"]))
    >>> convert_itos(pairwise_bwt_merge(a, b)) == naive_bwt(["ACGT", "TGCA"])
    True
    """
    bwt0 = np.asarray(bwt0, dtype=np.uint8)
    bwt1 = np.asarray(bwt1, dtype=np.uint8)
    if bwt0.size == 0:
        return bwt1.copy()
    if bwt1.size == 0:
        return bwt0.copy()
    wide = _wide(bwt0.size, bwt1.size, force_wide)
    with jax.enable_x64(wide):
        merged, _ = _merge_impl(
            jnp.asarray(bwt0), jnp.asarray(bwt1), int(bwt0.size),
            int(bwt1.size), wide=wide,
        )
        return np.asarray(merged)


def merge_interleave(bwt0, bwt1, force_wide: bool = False) -> np.ndarray:
    """The converged interleave vector (True == element from bwt0)."""
    bwt0 = np.asarray(bwt0, dtype=np.uint8)
    bwt1 = np.asarray(bwt1, dtype=np.uint8)
    wide = _wide(bwt0.size, bwt1.size, force_wide)
    with jax.enable_x64(wide):
        _, interleave = _merge_impl(
            jnp.asarray(bwt0), jnp.asarray(bwt1), int(bwt0.size),
            int(bwt1.size), wide=wide,
        )
        return np.asarray(interleave)


def multiway_bwt_merge(
    bwts: list[np.ndarray], force_wide: bool = False,
    return_sources: bool = False,
):
    """Merge D decoded BWTs in ONE doubling run (no pairwise tree).

    Equals ``kway_merge``'s pairwise-tree result, in ceil(log2 max
    rotation period) + 2 device rounds total instead of the tree's
    D-1 merges x max-period rounds. ``return_sources`` additionally
    returns the source id of every merged position (the D-way
    generalization of the pairwise interleave vector).

    >>> from msbwt_jax.ops.alphabet import convert_itos, convert_stoi
    >>> from msbwt_jax.utils.oracle import naive_bwt
    >>> parts = [convert_stoi(naive_bwt([s])) for s in ("AC", "GG", "TA")]
    >>> convert_itos(multiway_bwt_merge(parts)) == naive_bwt(["AC", "GG", "TA"])
    True
    """
    parts = [np.asarray(b, dtype=np.uint8) for b in bwts]
    sizes = [p.size for p in parts]
    n = int(sum(sizes))
    if n == 0:
        out = np.zeros(0, dtype=np.uint8)
        return (out, np.zeros(0, np.int32)) if return_sources else out
    syms = np.concatenate([p for p in parts if p.size])
    src = np.concatenate(
        [np.full(sz, i, np.int32) for i, sz in enumerate(sizes) if sz]
    )
    wide = force_wide or n >= 2**31
    with jax.enable_x64(wide):
        merged, srcs = _doubling_merge_impl(
            jnp.asarray(syms), jnp.asarray(src), n=n, wide=wide
        )
        merged = np.asarray(merged)
        srcs = np.asarray(srcs)
    return (merged, srcs) if return_sources else merged


def kway_merge(bwts: list[np.ndarray], force_wide: bool = False) -> np.ndarray:
    """Combine per-shard partial BWTs after a data-parallel build.

    Default engine is the one-shot doubling merge (``multiway_bwt_merge``);
    ``MSBWT_MERGE=tree`` selects the balanced binary tree of pairwise
    H-M merges (each pair independently goes wide once its size requires).

    >>> from msbwt_jax.ops.alphabet import convert_itos, convert_stoi
    >>> from msbwt_jax.utils.oracle import naive_bwt
    >>> parts = [convert_stoi(naive_bwt([s])) for s in ("AC", "GG", "TA")]
    >>> convert_itos(kway_merge(parts)) == naive_bwt(["AC", "GG", "TA"])
    True
    """
    if os.environ.get("MSBWT_MERGE") != "tree":
        return multiway_bwt_merge(bwts, force_wide=force_wide)
    parts = [np.asarray(b, dtype=np.uint8) for b in bwts if np.asarray(b).size]
    if not parts:
        return np.zeros(0, dtype=np.uint8)
    while len(parts) > 1:
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            nxt.append(
                pairwise_bwt_merge(parts[i], parts[i + 1], force_wide=force_wide)
            )
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]
