"""Batched column-wise MSBWT construction (BCR-style) — the accelerator
replacement for the reference's dynamic B+-tree insertion.

The reference builds the MSBWT one symbol at a time through a
pointer-chasing order-statistics B+ tree (ref: src/dynamic_bwt.rs:305-381,
src/rle_bplus_tree.rs, src/run_block_av_flat.rs). That algorithm is
inherently sequential. Here we build the *same mathematical object* with a
batched column-wise algorithm in the BCR / "massively parallel BWT of large
string sets" family (see PAPERS.md): all N reads advance together, one
suffix-column per step, inside a single ``lax.fori_loop``. Two engines run
the same step:

* ``engine="xla"`` (:func:`bcr_insert_core`): a uint8 buffer at the final
  capacity; each stage ranks through a one-hot occ table and rebuilds the
  buffer with flat scatters. ``parallel/`` traces this core inside
  ``shard_map``.
* ``engine="fused"`` (:func:`bcr_insert_core_fused`): the int32 phys layout
  of ``ops.merge_insert``, whose merge pass also emits the packed rank
  table. Each stage ranks with one row gather + popcount; large builds grow
  the capacity in buckets, long reads take two columns per pass (radix 2),
  and :func:`build_msbwt_with_index` derives the query indexes straight
  from the final table.

Correctness contract (proved by the oracle tests): the reference's *sorted*
insertion makes the output independent of input order — each string lands at
its lexicographic position (SURVEY.md §2; ref test src/dynamic_bwt.rs:515-525
feeds strings in non-lexicographic order and still matches ``naive_bwt``).
Ties between equal suffixes of different reads break by comparing the full
read cyclically, which equals ordering the reads' terminators by the reads'
lexicographic order. Hence: sort the reads, then run column-wise insertion
with terminator ranks = sorted read ranks == byte-identical output.

The same kernel implements *chronological* ("unsorted") insertion — terminator
ranks = arrival order (ref: src/dynamic_bwt.rs:350-351) — and *incremental
extension* of an existing BWT (the reference's load-and-add flow,
ref: src/dynamic_bwt.rs:734-773): the existing decoded BWT seeds the buffer
and the new batch's terminator positions come from a batched full backward
search (the reference's insertion-point search, ref: src/dynamic_bwt.rs:311-348,
without the adaptive short-circuit heuristic — batching amortizes what the
short-circuit was saving).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from msbwt_jax.ops import merge_insert as mi
from msbwt_jax.ops.alphabet import VC_LEN
from msbwt_jax.ops.rank import BIN, OccIndex, build_occ_index
from msbwt_jax.ops.rank import rank as _rank

_PAD = 7  # padding symbol for the BWT buffer (never matches 0..5)

# nibble-pack symbol uploads past this size: symbols are < 8, so two ride
# per byte and the host-to-device copy halves. Disable with
# MSBWT_NO_WIRE_PACK=1.
_WIRE_PACK_MIN_BYTES = 64 << 20


@functools.partial(jax.jit, static_argnames=("n",))
def _unpack_wire(packed, *, n):
    # split-half layout: low nibbles are elements [0, h), high nibbles
    # [h, 2h) — a concat of two shifts, no interleave
    lo = packed & jnp.uint8(0xF)
    hi = packed >> jnp.uint8(4)
    return jnp.concatenate([lo, hi])[:n]


def _upload_symbols(view):
    """Host->device upload of a u8 symbol array; big arrays are nibble-
    packed two-symbols-per-byte on the wire (split-half layout) and
    unpacked in one device pass."""
    import os

    if not isinstance(view, np.ndarray):
        return jnp.asarray(view)  # already on device
    if (view.nbytes < _WIRE_PACK_MIN_BYTES
            or os.environ.get("MSBWT_NO_WIRE_PACK")):
        return jnp.asarray(view)
    flat = view.reshape(-1)
    n = flat.size
    h = (n + 1) // 2
    lo = flat[:h]
    hi = np.zeros(h, np.uint8)
    hi[: n - h] = flat[h:]
    packed = lo | (hi << 4)
    return _unpack_wire(jnp.asarray(packed), n=n).reshape(view.shape)


# ---------------------------------------------------------------------------
# host-facing API
# ---------------------------------------------------------------------------

def encode_reads(reads: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length int-encoded reads into ``([N, Lmax] u8, [N] i32)``.

    Rows are zero-padded; since ``$`` == 0, a zero-padded row compares exactly
    like ``s + '$'`` — which makes plain row-wise lexsort the correct read
    order for sorted insertion.
    """
    n = len(reads)
    lengths = np.array([len(r) for r in reads], dtype=np.int32)
    lmax = int(lengths.max()) if n else 0
    packed = np.zeros((n, max(lmax, 1)), dtype=np.uint8)
    for i, r in enumerate(reads):
        arr = np.asarray(r, dtype=np.uint8)
        if arr.size and arr.min() == 0:
            raise ValueError("reads must not contain interior '$' (symbol 0)")
        packed[i, : arr.size] = arr
    return packed, lengths


@jax.jit
def _device_counts(decoded):
    return jnp.sum(
        decoded[:, None] == jnp.arange(VC_LEN, dtype=jnp.uint8)[None, :],
        axis=0, dtype=jnp.int32,
    )


def sort_reads(reads: np.ndarray, lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Lexicographic read sort (row-wise over the 0-padded matrix).

    Single-key sort over a fixed-width byte view — 2x faster than a
    column-per-column ``np.lexsort`` at 1M x 100bp."""
    L = reads.shape[1]
    keys = np.ascontiguousarray(reads).view(np.dtype((np.void, L))).ravel()
    order = np.argsort(keys, kind="stable")
    return reads[order], lengths[order]


def reads_to_cols(reads: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Column-major stage view: ``cols[j, i] = reads[i, lengths[i] - j]`` for
    ``1 <= j <= lengths[i]``, else 0. Built once on host so every BCR stage
    reads one contiguous row instead of issuing an N-element gather per
    stage.
    """
    N, L = reads.shape
    cols = np.zeros((L + 2, N), dtype=np.uint8)
    if N == 0:
        return cols
    if np.all(lengths == L):
        cols[1 : L + 1] = reads[:, ::-1].T
    else:
        js = np.arange(L + 2)
        idx = lengths[None, :] - js[:, None]          # [L+2, N]
        valid = (idx >= 0) & (js[:, None] >= 1)
        np.clip(idx, 0, L - 1, out=idx)
        cols = np.where(valid, reads.T[idx, np.arange(N)[None, :]], 0).astype(np.uint8)
    return cols


def _prepare_build(reads, lengths, sorted_insert, base, base_string_count,
                   base_rot_max, engine):
    """Shared host prep for the build entry points: validation, read sort,
    stage-view construction, terminator slots, engine pick. Returns a dict of
    everything the device drivers need (or ``None`` if there is no work)."""
    from msbwt_jax.utils.checks import validate_bwt, validate_reads

    reads = np.asarray(reads, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    validate_reads(reads, lengths)
    N = reads.shape[0]
    if base is None:
        base = np.zeros(0, dtype=np.uint8)
    if isinstance(base, np.ndarray):
        base = np.asarray(base, dtype=np.uint8)
        validate_bwt(base)
        base = _upload_symbols(base)
    # else: device-resident base (streaming extend) — stays on device
    n0 = int(base.shape[0])
    if N == 0:
        return None, base

    host_cols = None
    if sorted_insert:
        from msbwt_jax.utils.native import (
            reads_to_cols_native,
            sort_rows_native,
        )

        order = sort_rows_native(reads)
        if order is not None:
            # native fused path: argsort + gather + column view in C++
            host_cols = reads_to_cols_native(reads, lengths, order)
            lengths = lengths[order]
            if n0:
                reads = reads[order]  # only the extend path reads rows again
        else:
            reads, lengths = sort_reads(reads, lengths)
        if n0 == 0:
            base_pos = np.zeros(N, dtype=np.int32)
        else:
            base_index = build_occ_index(base, n0)
            if base_rot_max is None:
                base_rot_max = int(
                    read_lengths_from_bwt(base_index, base_string_count).max()
                ) + 1
            base_pos = np.asarray(
                terminator_positions(base_index, reads, lengths, base_rot_max)
            )
        # new-coordinate slots: each earlier batch read occupies one slot first
        q1 = base_pos + np.arange(N, dtype=np.int32)
    else:
        q1 = base_string_count + np.arange(N, dtype=np.int32)

    n_cap = n0 + int(lengths.sum()) + N
    if n_cap >= 2**31:
        raise ValueError("single-device build limited to 2^31-1 symbols; use parallel/")
    L = int(reads.shape[1])
    if n0:
        base_counts = _device_counts(base)
    else:
        base_counts = jnp.zeros(VC_LEN, jnp.int32)

    if engine is None:
        engine = default_engine()
    if engine not in ENGINES:
        raise ValueError(f"unknown build engine {engine!r}; expected one of "
                         f"{ENGINES}")
    if host_cols is not None:
        cols_on_device = False
        host_view = host_cols
    else:
        cols_on_device = bool(np.all(lengths == L))
        host_view = reads if cols_on_device else reads_to_cols(reads, lengths)
    return {
        "base": base, "q1": q1, "host_view": host_view, "lengths": lengths,
        "base_counts": base_counts, "n0": n0, "n_cap": n_cap, "L": L, "N": N,
        "n_strings_total": base_string_count + N, "engine": engine,
        "cols_on_device": cols_on_device,
    }, base


def build_msbwt(
    reads: np.ndarray,
    lengths: np.ndarray,
    sorted_insert: bool = True,
    base: np.ndarray | None = None,
    base_string_count: int = 0,
    base_rot_max: int | None = None,
    engine: str | None = None,
    device_out: bool = False,
) -> np.ndarray:
    """Construct (or extend) an MSBWT. Returns the decoded BWT (uint8 [n]).

    * ``sorted_insert=True``  == reference ``insert_string(s, true)`` batch
    * ``sorted_insert=False`` == chronological insertion (terminators in
      arrival order, ref: src/dynamic_bwt.rs:350-351)
    * ``base``                == decoded BWT to extend (load-and-add flow)
    * ``engine``              == stage-rebuild engine: "fused" (phys layout
      + fused rank table), "xla" (flat scatter), or None for
      :func:`default_engine`.
    * ``device_out``          == return the device array (skip the
      device->host copy; useful when an index is built next).
    """
    p, base = _prepare_build(reads, lengths, sorted_insert, base,
                             base_string_count, base_rot_max, engine)
    if p is None:
        return base if device_out else np.asarray(base)
    if (p["engine"] == "fused" and p["n_cap"] >= _BUCKET_MIN_SYMBOLS
            and p["L"] >= 8):
        # large build: bucketed capacity growth (see bucket_schedule)
        out = _bcr_insert_bucketed(
            p["base"], jnp.asarray(p["q1"]), _upload_symbols(p["host_view"]),
            jnp.asarray(p["lengths"]), p["base_counts"],
            n0=p["n0"], n_cap=p["n_cap"], L=p["L"], N=p["N"],
            n_strings_total=p["n_strings_total"],
            cols_on_device=p["cols_on_device"],
        )
    else:
        out = _bcr_insert(
            p["base"], jnp.asarray(p["q1"]), _upload_symbols(p["host_view"]),
            jnp.asarray(p["lengths"]), p["base_counts"],
            n0=p["n0"], n_cap=p["n_cap"], L=p["L"],
            n_strings_total=p["n_strings_total"], engine=p["engine"],
            cols_on_device=p["cols_on_device"],
            radix=build_radix(p["n_cap"], p["N"], n_base=p["n0"]),
        )
    return out if device_out else np.asarray(out)


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

def bcr_insert_core(base, q1, reads_cols, lengths, base_counts, *, n0, n_cap, L,
                    n_strings_total):
    """Traceable BCR core (also used inside ``shard_map`` by ``parallel/``).

    ``reads_cols`` is the ``[L+2, N]`` stage view from :func:`reads_to_cols`.
    ``n0``/``n_cap``/``L``/``n_strings_total`` are static; ``n_strings_total``
    may be a traced scalar when the caller computes it on device.
    Returns the buffer ``[n_cap]``; positions >= the true total are _PAD.
    """
    N = reads_cols.shape[1]
    NB = -(-n_cap // BIN)
    n_pad = NB * BIN
    arange_cap = jnp.arange(n_cap, dtype=jnp.int32)
    arange_pad = jnp.arange(n_pad, dtype=jnp.int32)

    def rebuild_occ(cur, n_valid):
        chunks = cur.reshape(NB, BIN)
        valid = arange_pad.reshape(NB, BIN) < n_valid
        per_bin = jnp.sum(
            (chunks[:, :, None] == jnp.arange(VC_LEN, dtype=jnp.uint8)[None, None, :])
            & valid[:, :, None],
            axis=1,
            dtype=jnp.int32,
        )
        return jnp.concatenate(
            [jnp.zeros((1, VC_LEN), jnp.int32),
             jnp.cumsum(per_bin, axis=0, dtype=jnp.int32)]
        )

    def insert(cur, n_valid, q, v, active):
        """Merge-insert values ``v`` at new-coordinate slots ``q`` (masked).

        Old element at position p shifts to p + #{active slots with
        old-coordinate insertion point <= p}; the sorted active slots' old
        coordinates are ``sort(q)[k] - k``.
        """
        m = jnp.sum(active.astype(jnp.int32))
        big = jnp.int32(n_pad)  # out-of-bounds for every scatter target below
        qs = jnp.sort(jnp.where(active, q, big))
        k = jnp.arange(N, dtype=jnp.int32)
        t = jnp.where(k < m, qs - k, big)
        delta = jnp.zeros(n_cap, jnp.int32).at[t].add(1, mode="drop")
        shift = jnp.cumsum(delta, dtype=jnp.int32)
        new_cur = jnp.full(n_pad, _PAD, jnp.uint8)
        src_dest = jnp.where(arange_cap < n_valid, arange_cap + shift, big)
        new_cur = new_cur.at[src_dest].set(cur[:n_cap], mode="drop")
        act_q = jnp.where(active, q, big)
        new_cur = new_cur.at[act_q].set(v, mode="drop")
        return new_cur, n_valid + m

    # --- stage 1: last characters at precomputed terminator slots ---
    # reads with length < 0 are padding rows (used by the sharded builder to
    # equalize per-device read counts); they never insert anything
    active0 = lengths >= 0
    arange6 = jnp.arange(VC_LEN, dtype=jnp.int32)
    cur = jnp.full(n_pad, _PAD, jnp.uint8)
    cur = cur.at[:n0].set(base[:n0]) if n0 else cur
    v1 = reads_cols[1]
    cur, n_valid = insert(cur, jnp.int32(n0), q1, v1, active0)
    occ = rebuild_occ(cur, n_valid)
    counts = _bump_counts(base_counts, v1, active0)
    P = q1
    prev_v = v1

    def stage(j, carry):
        cur, occ, P, counts, prev_v, n_valid = carry
        active = j <= lengths + 1
        v = jax.lax.dynamic_slice_in_dim(reads_cols, j, 1, axis=0)[0]
        f = prev_v.astype(jnp.int32)
        # rank of f at position P over the current buffer (row gathers, as
        # in ops.rank.rank)
        b = P // BIN
        window = jnp.take(cur.reshape(NB, BIN), b, axis=0)
        occ_row = jnp.take(occ, b, axis=0)
        f_onehot = f[:, None] == arange6[None, :]
        base_r = jnp.sum(occ_row * f_onehot, axis=1, dtype=jnp.int32)
        local = jnp.sum(
            (window == prev_v[:, None])
            & (jnp.arange(BIN, dtype=jnp.int32)[None, :] < (P % BIN)[:, None]),
            axis=1,
            dtype=jnp.int32,
        )
        # C[f] = #rotations whose first char < f ('$' occurrences in the
        # buffer belong to full rotations and are not counted; see _cvec)
        q = _cvec(counts, n_strings_total)[f] + base_r + local
        cur, n_valid = insert(cur, n_valid, q, v, active)
        occ = rebuild_occ(cur, n_valid)
        P = jnp.where(active, q, P)
        counts = _bump_counts(counts, v, active)
        prev_v = jnp.where(active, v, prev_v)
        return cur, occ, P, counts, prev_v, n_valid

    cur, occ, P, counts, prev_v, n_valid = jax.lax.fori_loop(
        2, L + 2, stage, (cur, occ, P, counts, prev_v, n_valid)
    )
    return cur[:n_cap]


def _rank_from_table(table, f, P):
    """rank(f, P) off the fused packed rank table: one row gather +
    popcount over plane-match bytes.

    The table (layout in ``ops.merge_insert``) is emitted by the merge pass
    that wrote the buffer, so a stage's rank needs no separate occ rebuild.
    It is phys-row-indexed: logical bin b lives at row b + CS (front guard).
    """
    arange6 = jnp.arange(VC_LEN, dtype=jnp.int32)
    b = P // BIN
    row = jnp.take(table, b + mi.CS, axis=0)  # phys row of logical bin
    occ_base = jnp.sum(
        jnp.where(arange6[None, :] == f[:, None], row[:, :VC_LEN], 0),
        axis=1, dtype=jnp.int32,
    )
    match = jnp.full((f.shape[0], 16), -1, jnp.int32)
    for p in range(3):
        words = row[:, mi.PLANE_BASE + 16 * p : mi.PLANE_BASE + 16 * p + 16]
        sp = -((f >> p) & 1)
        match = match & ~(words ^ sp[:, None])
    match = match & 0xFF
    q8 = jnp.arange(16, dtype=jnp.int32)[None, :] * 8
    sh = jnp.clip((P - b * BIN)[:, None] - q8, 0, 8)
    pmask = (jnp.int32(1) << sh) - 1
    local = jnp.sum(
        jax.lax.population_count(match & pmask), axis=1, dtype=jnp.int32
    )
    return occ_base + local


def _bump_counts(counts, v, active):
    # compare+reduce instead of an N-element scatter-add
    arange6 = jnp.arange(VC_LEN, dtype=jnp.int32)
    return counts + jnp.sum(
        (v.astype(jnp.int32)[:, None] == arange6[None, :]) & active[:, None],
        axis=0,
        dtype=jnp.int32,
    )


def _cvec(counts, n_strings_total):
    """C-array over rotation space: cvec[0] = 0; cvec[f>=1] counts every
    string's '$' rotation (n_strings_total, including not-yet-inserted
    terminators — the invariant that makes batched stages order-consistent)
    plus buffer occurrences of symbols 1..f-1."""
    cs = jnp.cumsum(counts, dtype=jnp.int32)
    return jnp.concatenate(
        [jnp.zeros(1, jnp.int32),
         jnp.asarray(n_strings_total, jnp.int32) + (cs[:-1] - counts[0])]
    )


def _fused_stage_step(j, carry, reads_cols, lengths, n_strings_total):
    """One BCR stage on the phys-layout carry (shared by the monolithic core
    and the bucketed driver)."""
    cur, table, P, counts, prev_v, n_valid = carry
    active = j <= lengths + 1
    v = jax.lax.dynamic_slice_in_dim(reads_cols, j, 1, axis=0)[0]
    f = prev_v.astype(jnp.int32)
    q = _cvec(counts, n_strings_total)[f] + _rank_from_table(table, f, P)
    cur, table, m = mi.merge_insert_phys(cur, q, v.astype(jnp.int32), active)
    n_valid = n_valid + m
    P = jnp.where(active, q, P)
    counts = _bump_counts(counts, v, active)
    prev_v = jnp.where(active, v, prev_v)
    return cur, table, P, counts, prev_v, n_valid


def _fused_stage_step2(j, carry, reads_cols, lengths, n_strings_total):
    """TWO BCR columns (j, j+1) through ONE merge pass — the radix-2 stage.

    The merge-insert pass streams the whole buffer (capacity-proportional),
    while position math is N-proportional; consuming two columns per pass
    halves the dominant buffer traffic. Column j's slot is the standard LF
    position q1 = cvec0[f] + rank_B0(f, P). Column j+1 needs a rank over the
    intermediate buffer B1 (B0 + all column-j inserts), which decomposes
    without materializing B1:

        rank_B1(s, q1_i) = rank_B0(s, q1_i - c_i)
                           + #{k active: q1_k < q1_i and v1_k = s}

    (c_i = #{k: q1_k < q1_i}; the subtraction maps the B1 slot back to B0
    coordinates, the second term counts same-stage same-symbol inserts).
    v2 slots q2 = cvec1[v1] + rank_B1(v1, q1) are already final (B2)
    coordinates; v1 slots shift past the q2 slots by the stable-merge rule
    f1 = q1 + #{k: sort(q2)_k - k <= q1} (a searchsorted on a monotone
    predicate). All corrections are [N]-sized sorts/cumsums.

    Reads inactive for column j+1 (odd tails of variable-length reads)
    insert only v1; fully inactive reads insert nothing — same masking
    contract as the single-column stage.
    """
    cur, table, P, counts, prev_v, n_valid = carry
    N = P.shape[0]
    arange6 = jnp.arange(VC_LEN, dtype=jnp.int32)
    big = jnp.int32(2**30)
    pos_max = jnp.int32((table.shape[0] - 1) * BIN)  # rank clip bound

    # --- column j (slots in B1 coordinates) ---
    active1 = j <= lengths + 1
    v1 = jax.lax.dynamic_slice_in_dim(reads_cols, j, 1, axis=0)[0]
    f = prev_v.astype(jnp.int32)
    r1 = _rank_from_table(table, f, P)
    q1 = _cvec(counts, n_strings_total)[f] + r1
    q1m = jnp.where(active1, q1, big)

    # c_i = #{active k: q1_k < q1_i}: q1 distinct among actives, inactives
    # sort last (stable argsort), so the sorted index IS the count
    order1 = jnp.argsort(q1m)
    inv1 = jnp.zeros(N, jnp.int32).at[order1].set(
        jnp.arange(N, dtype=jnp.int32)
    )
    old_pos = jnp.clip(q1 - inv1, 0, pos_max)

    # --- column j+1 ---
    active2 = (j + 1) <= lengths + 1  # active2 implies active1 (monotone)
    v2 = jax.lax.dynamic_slice_in_dim(reads_cols, j + 1, 1, axis=0)[0]
    v1i = v1.astype(jnp.int32)
    r2_base = _rank_from_table(table, v1i, old_pos)
    # in-batch same-symbol count, computed in q1-sorted order
    v1_sorted = jnp.take(jnp.where(active1, v1i, VC_LEN), order1)
    onehot = v1_sorted[:, None] == arange6[None, :]
    pref = jnp.cumsum(onehot, axis=0, dtype=jnp.int32) - onehot
    inb = jnp.take(jnp.sum(jnp.where(onehot, pref, 0), axis=1), inv1)
    counts1 = _bump_counts(counts, v1, active1)
    q2 = _cvec(counts1, n_strings_total)[v1i] + r2_base + inb
    q2m = jnp.where(active2, q2, big)

    # v1 slots -> final (B2) coordinates: shift past the q2 slots. The
    # predicate sort(q2m)_k - k <= q1 is true on a prefix (actives are
    # strictly increasing; the `big` tail never fires for q1 < 2^30 - N),
    # so searchsorted is exact; method="sort" is one [2N] sort instead of
    # N binary searches.
    bk = jnp.sort(q2m) - jnp.arange(N, dtype=jnp.int32)
    f1 = q1 + jnp.searchsorted(
        bk, q1, side="right", method="sort"
    ).astype(jnp.int32)

    q_all = jnp.concatenate([jnp.where(active1, f1, 0), jnp.where(active2, q2, 0)])
    v_all = jnp.concatenate([v1, v2]).astype(jnp.int32)
    act_all = jnp.concatenate([active1, active2])
    cur, table, m = mi.merge_insert_phys(cur, q_all, v_all, act_all)
    n_valid = n_valid + m
    P = jnp.where(active2, q2, jnp.where(active1, f1, P))
    counts = _bump_counts(counts1, v2, active2)
    prev_v = jnp.where(active2, v2, jnp.where(active1, v1, prev_v))
    return cur, table, P, counts, prev_v, n_valid


def _fused_stage1(base, q1, reads_cols, lengths, base_counts, *, n0, n_cap):
    """Initialize the phys buffer and run stage 1 (terminator-slot inserts).
    Returns the stage-loop carry."""
    base_log = jnp.full(n_cap, _PAD, jnp.int32)
    if n0:
        base_log = jax.lax.dynamic_update_slice(
            base_log, base[:n0].astype(jnp.int32), (0,)
        )
    active0 = lengths >= 0
    cur = mi.to_phys(base_log, n_cap)
    v1 = reads_cols[1]
    cur, table, m = mi.merge_insert_phys(
        cur, q1, v1.astype(jnp.int32), active0
    )
    counts = _bump_counts(base_counts, v1, active0)
    return cur, table, q1, counts, v1, jnp.int32(n0) + m


def build_radix(n_cap: int | None = None, n_reads: int | None = None,
                n_base: int = 0) -> int:
    """Columns consumed per merge pass on the fused engine.

    The double-stage's [N]-sized corrections (argsort, scatter,
    sort-based searchsorted, extra rank gather) are N-proportional while
    the merge saving is capacity-proportional, so the sign flips with
    read LENGTH at fixed total symbols: radix 2 pays off only for long
    reads. Auto selects radix 2 when the mean sequence length OF THE NEW
    BATCH is >= 1000. That threshold is not measured on the H100. For
    extend flows ``n_base`` (the existing base length, part of ``n_cap``)
    is subtracted first so that extending a large base with a small batch
    of short reads does not land in the radix-2 regime.
    ``MSBWT_RADIX=1|2`` forces either.

    >>> build_radix(505_000_000, 5_000_000)   # 100bp short reads
    1
    >>> build_radix(500_500_000, 1_000_000)   # 500bp
    1
    >>> build_radix(500_500_000, 500_000)     # 1000bp long reads
    2
    >>> build_radix(505_101_000, 1_000, n_base=505_000_000)  # extend, L=100
    1
    >>> build_radix()                         # unknown shape: stay at 1
    1
    """
    import os

    v = os.environ.get("MSBWT_RADIX", "auto")
    if v == "2":
        return 2
    if v == "1":
        return 1
    if n_cap and n_reads and (n_cap - n_base) / n_reads >= 1000:
        return 2
    return 1


def _fused_stage_loop(carry, reads_cols, lengths, n_strings_total, L, radix):
    """Run columns 2..L+1 on the phys carry, radix-2 pairs + odd tail."""
    if radix == 2 and L >= 2:
        n_pairs = L // 2
        carry = jax.lax.fori_loop(
            0, n_pairs,
            lambda t, c: _fused_stage_step2(
                2 + 2 * t, c, reads_cols, lengths, n_strings_total
            ),
            carry,
        )
        if L % 2:
            carry = _fused_stage_step(
                L + 1, carry, reads_cols, lengths, n_strings_total
            )
        return carry
    return jax.lax.fori_loop(
        2, L + 2,
        lambda j, c: _fused_stage_step(j, c, reads_cols, lengths,
                                       n_strings_total),
        carry,
    )


def _stage_view_on_device(reads):
    """Equal-length ``[N, L]`` reads -> the ``[L+2, N]`` stage view of
    :func:`reads_to_cols`, built on device (saves a host pass and keeps the
    host->device transfer minimal)."""
    zero = jnp.zeros((1, reads.shape[0]), jnp.uint8)
    return jnp.concatenate([zero, jnp.flip(reads, axis=1).T, zero], axis=0)


def bcr_insert_core_fused(base, q1, reads_cols, lengths, base_counts, *, n0,
                          n_cap, L, n_strings_total, radix=1):
    """BCR core on the fused engine: same math as :func:`bcr_insert_core`,
    but the buffer lives in the int32 phys layout of ``ops.merge_insert``
    and every stage rebuild also emits the packed rank table the next
    stage ranks from. Returns ``[n_cap]`` uint8; positions >= the true
    total are _PAD.
    """
    carry = _fused_stage1(
        base, q1, reads_cols, lengths, base_counts, n0=n0, n_cap=n_cap,
    )
    carry = _fused_stage_loop(
        carry, reads_cols, lengths, n_strings_total, L, radix
    )
    return mi.from_phys(carry[0], n_cap).astype(jnp.uint8)


@functools.partial(
    jax.jit,
    static_argnames=("n0", "n_cap", "L", "n_strings_total", "engine",
                     "cols_on_device", "radix"),
)
def _bcr_insert(base, q1, reads_cols, lengths, base_counts, *, n0, n_cap, L,
                n_strings_total, engine="xla", cols_on_device=False, radix=1):
    if cols_on_device:
        reads_cols = _stage_view_on_device(reads_cols)
    if engine == "fused":
        return bcr_insert_core_fused(
            base, q1, reads_cols, lengths, base_counts,
            n0=n0, n_cap=n_cap, L=L, n_strings_total=n_strings_total,
            radix=radix,
        )
    return bcr_insert_core(
        base, q1, reads_cols, lengths, base_counts,
        n0=n0, n_cap=n_cap, L=L, n_strings_total=n_strings_total,
    )


ENGINES = ("xla", "fused")
# Chosen by timing both engines on the 505M-symbol E. coli build on one
# H100 (PERF.md); the same default holds on every backend.
DEFAULT_ENGINE = "fused"


def default_engine() -> str:
    """The stage-rebuild engine used when a caller names none."""
    return DEFAULT_ENGINE


# ---------------------------------------------------------------------------
# bucketed capacity growth: early BCR stages run on a nearly-empty buffer, so
# streaming the FULL final capacity through every stage wastes ~2x memory
# traffic. Large builds run the stage loop in capacity buckets that grow as
# the buffer fills — each bucket is one jitted program over a fixed phys
# shape; the carry is padded up between buckets (one copy, ~1 stage's
# cost per bucket). ~log_growth(L) programs total.
# ---------------------------------------------------------------------------

_BUCKET_MIN_SYMBOLS = 2_000_000  # below this a single program wins


@functools.partial(jax.jit, static_argnames=("n0", "n_cap", "cols_on_device"))
def _bcr_stage1_jit(base, q1, reads_cols, lengths, base_counts, *, n0, n_cap,
                    cols_on_device):
    if cols_on_device:
        reads_cols = _stage_view_on_device(reads_cols)
    carry = _fused_stage1(
        base, q1, reads_cols, lengths, base_counts, n0=n0, n_cap=n_cap,
    )
    return reads_cols, carry


@jax.jit
def _bcr_block_jit(cur, table, P, counts, prev_v, n_valid, reads_cols,
                   lengths, n_strings_total, ja, jb):
    # ja/jb are traced scalars: every bucket at a given phys shape reuses one
    # compiled program (fori_loop lowers to while_loop)
    return jax.lax.fori_loop(
        ja, jb,
        lambda j, c: _fused_stage_step(j, c, reads_cols, lengths,
                                       n_strings_total),
        (cur, table, P, counts, prev_v, n_valid),
    )


@jax.jit
def _bcr_block_jit2(cur, table, P, counts, prev_v, n_valid, reads_cols,
                    lengths, n_strings_total, ja, npairs):
    """Radix-2 bucket block: ``npairs`` double-column stages from column
    ``ja`` (both traced — one compiled program per phys shape)."""
    return jax.lax.fori_loop(
        0, npairs,
        lambda t, c: _fused_stage_step2(
            ja + 2 * t, c, reads_cols, lengths, n_strings_total
        ),
        (cur, table, P, counts, prev_v, n_valid),
    )


@functools.partial(jax.jit, static_argnames=("new_rows",))
def _grow_carry(cur, table, *, new_rows):
    pad = jnp.full((new_rows, 128), _PAD, cur.dtype)
    cur2 = jax.lax.dynamic_update_slice(pad, cur, (0, 0))
    # grown table rows are never gathered before the next stage rewrites the
    # whole table (P < old capacity), so zero-fill is fine
    tab2 = jax.lax.dynamic_update_slice(
        jnp.zeros((new_rows, table.shape[1]), jnp.int32), table, (0, 0)
    )
    return cur2, tab2


@functools.partial(jax.jit, static_argnames=("n_cap",))
def _from_phys_jit(phys, *, n_cap):
    return mi.from_phys(phys, n_cap).astype(jnp.uint8)


def _bucket_growth() -> float:
    """Capacity growth factor between stage buckets (env
    ``MSBWT_BUCKET_GROWTH``, default 1.3, clamped to [1.05, 4]).

    The merge pass streams the whole CAPACITY each stage, so the mean
    capacity/size overhead over a bucket's stages is r*ln(r)/(r-1): 1.39x
    at r=2, 1.14x at r=1.3 — a smaller factor trades extra compiled shapes
    (log_r of the total growth) for proportionally less streamed padding.
    The default is not measured on the H100.
    """
    import os

    try:
        g = float(os.environ.get("MSBWT_BUCKET_GROWTH", "1.3"))
    except ValueError:
        g = 1.3
    return min(max(g, 1.05), 4.0)


def bucket_schedule(n0: int, N: int, L: int, n_cap: int,
                    chunk: int, growth: float | None = None
                    ) -> list[tuple[int, int, int]]:
    """Stage buckets ``(ja, jb, cap)``: run stages [ja, jb) at capacity
    ``cap`` (chunk-aligned, >= n0 + (jb-1)*N — stage j ends with at most
    n0 + j*N symbols).

    >>> sched = bucket_schedule(0, 10, 20, 220, 16)
    >>> sched[0][0], sched[-1][1]  # covers stages [2, L+2) contiguously
    (2, 22)
    >>> all(c >= 0 + (jb - 1) * 10 for ja, jb, c in sched)  # capacity holds
    True
    """
    def aligned(x):
        return -(-x // chunk) * chunk

    if growth is None:
        growth = _bucket_growth()
    full_cap = aligned(n_cap)
    buckets = []
    ja = 2
    while ja < L + 2:
        need = n0 + ja * N
        cap = min(aligned(int(growth * need)), full_cap)
        if cap == full_cap:
            # the full-capacity bucket holds everything by n_cap's definition
            # (stage-end bound n0 + j*N is LOOSE for ragged reads — do not
            # grow past full_cap chasing it)
            jb = L + 2
        else:
            # cap >= growth*need >= n0 + ja*N, so even a forced single-stage
            # bucket (jb = ja + 1) fits its last stage's output
            jb = max(min((cap - n0) // N + 1, L + 2), ja + 1)
        buckets.append((ja, jb, cap))
        ja = jb
    return buckets


def _bcr_insert_bucketed(base, q1, reads_cols, lengths, base_counts, *, n0,
                         n_cap, L, N, n_strings_total, cols_on_device,
                         return_carry=False):
    radix = build_radix(n_cap, N, n_base=n0)
    buckets = bucket_schedule(n0, N, L, n_cap, mi.CHUNK)
    if radix == 2:
        # even-length buckets (shrink, never extend — a pair must fit its
        # bucket's capacity) so pair blocks need no odd-tail programs except
        # possibly in the final full-capacity bucket
        adj, a = [], buckets[0][0]
        for (_ja, b, cap) in buckets:
            if b < L + 2 and (b - a) >= 3:
                b = a + ((b - a) // 2) * 2
            adj.append((a, b, cap))
            a = b
        buckets = adj
    cap0 = buckets[0][2]  # covers stage 1 too (needs n0 + N <= cap0)
    reads_cols, carry = _bcr_stage1_jit(
        base, q1, reads_cols, lengths, base_counts,
        n0=n0, n_cap=cap0, cols_on_device=cols_on_device,
    )
    nst = jnp.asarray(n_strings_total, jnp.int32)
    cur_cap = cap0
    for ja, jb, cap in buckets:
        if cap != cur_cap:
            cur, table = _grow_carry(
                carry[0], carry[1], new_rows=mi.phys_rows(cap)
            )
            carry = (cur, table) + tuple(carry[2:])
            cur_cap = cap
        a = ja
        if radix == 2:
            npairs = (jb - a) // 2
            if npairs:
                carry = _bcr_block_jit2(
                    *carry, reads_cols, lengths, nst,
                    jnp.int32(a), jnp.int32(npairs),
                )
                a += 2 * npairs
        if a < jb:
            carry = _bcr_block_jit(
                *carry, reads_cols, lengths, nst, jnp.int32(a), jnp.int32(jb),
            )
    if return_carry:
        return carry
    return _from_phys_jit(carry[0], n_cap=n_cap)


# ---------------------------------------------------------------------------
# fused index derivation: the final merge pass already emitted the packed
# rank table for the finished BWT, so the query indexes fall out of the
# build's device state with slicing + byte repacking only — no decoded host
# round-trip, no one-hot occ rebuild (this replaces the load path the
# reference runs after a build, ref: src/rle_bwt.rs:324-467 standard_init).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n",))
def _derive_indexes_from_phys(phys, table_phys, counts, *, n):
    """(phys buffer, fused phys table, [6] counts) -> device index parts.

    Returns ``(bwt_padded u8 [NB*BIN], occ i32 [NB+1, 6], starts i32 [7],
    ptab i32 [NB+1, 32])`` — exactly what ``rank.build_occ_index`` +
    ``packed_rank.pack_index`` compute from decoded symbols, but read
    straight off the build's fused table. Bit order is identical: fused
    lane PLANE_BASE+16p+q holds positions 8q..8q+7 of plane p (bit m =
    position 8q+m), so packed word j = bytes 4j..4j+3 assembled
    little-endian covers positions 32j..32j+31 with bit k = position 32j+k.
    """
    NB = max(1, -(-n // BIN))
    flat = phys.reshape(-1)
    bwt = flat[mi.CHUNK : mi.CHUNK + NB * BIN].astype(jnp.uint8)
    body = table_phys[mi.CS : mi.CS + NB]           # [NB, TABLE_LANES]
    occ = jnp.concatenate([body[:, :VC_LEN], counts[None, :]], axis=0)
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )
    ptab = jnp.zeros((NB + 1, 32), jnp.int32)
    ptab = ptab.at[:, :VC_LEN].set(occ)
    for p in range(3):
        lane = mi.PLANE_BASE + 16 * p
        q = body[:, lane : lane + 16]               # [NB, 16] plane bytes
        words = (
            q[:, 0::4] | (q[:, 1::4] << 8) | (q[:, 2::4] << 16)
            | (q[:, 3::4] << 24)
        )
        ptab = ptab.at[:NB, 8 + 4 * p : 12 + 4 * p].set(words)
    return bwt, occ, starts, ptab


def build_msbwt_with_index(
    reads: np.ndarray,
    lengths: np.ndarray,
    sorted_insert: bool = True,
    base: np.ndarray | None = None,
    base_string_count: int = 0,
    base_rot_max: int | None = None,
    engine: str | None = None,
):
    """Construct an MSBWT and return its query indexes WITHOUT leaving the
    device: ``(OccIndex, PackedOccIndex)``.

    On the fused engine the packed rank table is the one the final merge
    pass emitted — deriving both indexes is one slicing/repacking pass
    instead of occ/pack rebuilds from the decoded symbols. The XLA engine
    rebuilds from the decoded output — identical results, pinned by tests.
    """
    from msbwt_jax.ops.packed_rank import PackedOccIndex, pack_index

    p, base = _prepare_build(reads, lengths, sorted_insert, base,
                             base_string_count, base_rot_max, engine)
    if p is None:
        idx = build_occ_index(base)
        return idx, pack_index(idx)
    if p["engine"] != "fused":
        out = _bcr_insert(
            p["base"], jnp.asarray(p["q1"]), _upload_symbols(p["host_view"]),
            jnp.asarray(p["lengths"]), p["base_counts"],
            n0=p["n0"], n_cap=p["n_cap"], L=p["L"],
            n_strings_total=p["n_strings_total"], engine=p["engine"],
            cols_on_device=p["cols_on_device"],
        )
        idx = build_occ_index(out, p["n_cap"])
        return idx, pack_index(idx)
    if p["n_cap"] >= _BUCKET_MIN_SYMBOLS and p["L"] >= 8:
        carry = _bcr_insert_bucketed(
            p["base"], jnp.asarray(p["q1"]), _upload_symbols(p["host_view"]),
            jnp.asarray(p["lengths"]), p["base_counts"],
            n0=p["n0"], n_cap=p["n_cap"], L=p["L"], N=p["N"],
            n_strings_total=p["n_strings_total"],
            cols_on_device=p["cols_on_device"], return_carry=True,
        )
    else:
        carry = _bcr_insert_fused_carry(
            p["base"], jnp.asarray(p["q1"]), _upload_symbols(p["host_view"]),
            jnp.asarray(p["lengths"]), p["base_counts"],
            n0=p["n0"], n_cap=p["n_cap"], L=p["L"],
            n_strings_total=p["n_strings_total"],
            cols_on_device=p["cols_on_device"],
            radix=build_radix(p["n_cap"], p["N"], n_base=p["n0"]),
        )
    bwt, occ, starts, ptab = _derive_indexes_from_phys(
        carry[0], carry[1], carry[3], n=p["n_cap"]
    )
    idx = OccIndex(bwt=bwt, occ=occ, starts=starts, n=p["n_cap"])
    return idx, PackedOccIndex(table=ptab, starts=starts, n=p["n_cap"])


@functools.partial(
    jax.jit,
    static_argnames=("n0", "n_cap", "L", "n_strings_total", "cols_on_device",
                     "radix"),
)
def _bcr_insert_fused_carry(base, q1, reads_cols, lengths, base_counts, *,
                            n0, n_cap, L, n_strings_total, cols_on_device,
                            radix):
    """Monolithic fused build returning the raw carry (phys buffer, fused
    table, P, counts, prev_v, n_valid) for fused index derivation."""
    if cols_on_device:
        reads_cols = _stage_view_on_device(reads_cols)
    carry = _fused_stage1(
        base, q1, reads_cols, lengths, base_counts, n0=n0, n_cap=n_cap,
    )
    return _fused_stage_loop(
        carry, reads_cols, lengths, n_strings_total, L, radix
    )


@functools.partial(jax.jit, static_argnames=("n", "t_total"))
def _terminator_positions_impl(table, starts, n, reads, lengths, steps, t_total):
    """Batched *cyclic* backward search: the true rotation-order rank of each
    new read's terminator rotation among the existing terminator rotations.

    The reference's insertion-point search walks the finite read once
    (ref: src/dynamic_bwt.rs:311-331) and compensates for terminator ties
    through its sequential update order. A batched builder needs the true
    cyclic rank directly, so we backward-search the pattern ``('$'+S)``
    repeated until it is longer than any existing rotation's period plus the
    new read's period (Fine–Wilf: two distinct periodic sequences must differ
    within the sum of their periods). Each read processes ``steps[i]`` LF
    steps — a whole number of cycles, so the walk ends on a '$' step and the
    running upper bound is the terminator rank.
    """
    from msbwt_jax.ops.packed_rank import rank_packed

    N, L = reads.shape
    pos = jnp.full(N, n, jnp.int32)
    m = lengths + 1  # cycle length of '$' + S

    def step(t, pos):
        active = t < steps
        # pattern processed right-to-left: step t handles cycle index
        # (len - t) mod m; index 0 is '$', index k is S[k-1]
        r = jnp.mod(lengths - t, m)
        sym = jnp.where(
            r == 0,
            jnp.int32(0),
            jnp.take_along_axis(
                reads, jnp.clip(r - 1, 0, L - 1)[:, None], axis=1
            )[:, 0].astype(jnp.int32),
        )
        new_pos = starts[sym] + rank_packed(table, sym, pos)
        return jnp.where(active, new_pos, pos)

    # t_total is the static worst case; the true bound is the largest
    # per-read step count (a traced value — fori_loop lowers to while)
    return jax.lax.fori_loop(
        0, jnp.minimum(jnp.max(steps), t_total), step, pos
    )


def read_lengths_from_bwt(index: OccIndex, n_strings: int) -> np.ndarray:
    """Recover each string's length from a BWT by LF-walking backwards from
    every terminator rotation (rows 0..n_strings-1) until the '$' closes the
    cycle. Vectorized over all strings; host loop bounded by the longest read."""
    if n_strings == 0:
        return np.zeros(0, dtype=np.int32)
    pos = jnp.arange(n_strings, dtype=jnp.int32)
    done = np.zeros(n_strings, dtype=bool)
    lengths = np.zeros(n_strings, dtype=np.int32)
    while not done.all():
        sym = np.asarray(index.bwt[pos])
        done_now = (sym == 0) | done
        lengths += (~done_now).astype(np.int32)
        sym_j = jnp.asarray(np.where(done_now, 0, sym).astype(np.int32))
        pos = index.starts[sym_j] + _rank(index, sym_j, pos)
        done = done_now
    return lengths


def terminator_positions(index: OccIndex, reads, lengths, base_rot_max: int):
    """Terminator-rotation ranks for a batch of new reads vs an existing BWT.

    ``base_rot_max`` must be >= the longest rotation (read length + 1)
    present in the base BWT.
    """
    from msbwt_jax.ops.packed_rank import pack_index

    lengths = jnp.asarray(lengths, dtype=jnp.int32)
    reads = jnp.asarray(reads)
    m = lengths + 1
    reps = -(-jnp.int32(base_rot_max) // m) + 1
    steps = reps * m
    L = int(reads.shape[1])
    t_total = int(base_rot_max) + 2 * (L + 1)
    pidx = pack_index(index)  # one packed-row gather per LF step
    return _terminator_positions_impl(
        pidx.table, pidx.starts, index.n, reads, lengths, steps, t_total
    )
