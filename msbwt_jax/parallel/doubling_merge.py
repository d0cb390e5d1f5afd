"""Distributed prefix-doubling D-way BWT merge over a device mesh.

The sharded Holt–McMillan merge (``parallel.sharded_merge``) needs up to
max-rotation-period refinement rounds (~101 for 100 bp reads, 1000+ for
long reads), each a full cross-device exchange. This module runs the same
fixpoint as ``ops.merge._doubling_merge_impl`` — rank prefix-doubling over
the union of rotations (sort by ``(rank_k, rank_k ∘ psi^k)`` doubles the
resolved depth) — but SPMD over the mesh, so a pod-scale merge converges in
``ceil(log2 max-period) + 2`` rounds (~8 for 100 bp; ~11 for 1 kb reads).
Merge semantics match the reference's pairwise refinement
(ref: src/bwt_util.rs:21-141) generalized D-way; ties (identical rotations)
keep source-major input order, the order H-M converges to.

Layout: the source-major element stream (all sources' BWT rows concatenated)
is sharded by global element index into D blocks of ``blk``. Every round is
built from two O(n/D)-traffic primitives riding the same ragged-all-to-all
transport as the H-M merge (``_exchange_native`` on accelerators, exact
dense simulation on CPU meshes):

* ``dist_scatter`` — route (global position, value) pairs to the position's
  owner block (positions here are always permutations, so per-device receive
  volume is exactly its own blk),
* a distributed stable sample sort (PSRS: local sort, D regular samples per
  device, splitter partition, one ragged exchange into 2*blk-capacity
  buffers — the classic PSRS bound — re-sort, global position-style ranks
  via cross-device group-start propagation).

psi (the successor-rotation map, = LF^-1 per source) is computed
analytically from per-(device, source, symbol) count cubes — no global sort
— and inverted with one ``dist_scatter``.

Per-round traffic is ~13 single-chunk-per-peer ragged exchanges of <= 2n/D
elements per device; with ~8 rounds total that is ~4x less volume and ~12x
fewer synchronization barriers than the 101-round H-M refinement at 100 bp.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from msbwt_jax.ops.alphabet import VC_LEN
from msbwt_jax.parallel.mesh import AXIS, default_mesh
from msbwt_jax.parallel.sharded_merge import (
    _exchange_native,
    _exchange_sim,
)

_PAD_SYM = 7


@functools.partial(
    jax.jit, static_argnames=("n", "blk", "d", "ns", "mesh", "native", "wide")
)
def _doubling_sharded_impl(syms, src, *, n, blk, d, ns, mesh, native,
                           wide=False):
    """syms/src: [D, blk] i32 element-sharded source-major stream (pads:
    sym=_PAD_SYM, src=ns). Returns (merged syms, source ids) as [D, blk]
    i32 sharded by merged position."""
    pos_dtype = jnp.int64 if wide else jnp.int32
    BIG = jnp.asarray(d * blk, pos_dtype)     # drop/fill sentinel
    cap = 2 * blk + d                         # PSRS part-size bound + slack

    def exchange(operand, out, in_off, send_sz, out_off, recv_sz):
        if operand.dtype != out.dtype:
            raise TypeError(
                f"ragged exchange dtype mismatch: {operand.dtype} vs "
                f"{out.dtype}"
            )
        if native:
            return _exchange_native(operand, out, in_off, send_sz, out_off,
                                    recv_sz)
        return _exchange_sim(operand, out, in_off, send_sz, out_off, recv_sz,
                             d=d)

    def program(syms_blk, src_blk):
        syms_l = syms_blk[0]
        src_l = src_blk[0]
        me = jax.lax.axis_index(AXIS)
        pos0 = me.astype(pos_dtype) * blk
        gid = pos0 + jnp.arange(blk, dtype=pos_dtype)
        valid = gid < n
        srcs_axis = jnp.arange(d, dtype=jnp.int32)

        def dist_scatter(p, v, fill):
            """out[p[i] - owner_base] = v[i] on p[i]'s owner; p >= BIG
            dropped. p entries must be distinct (permutation fragments), so
            each device receives at most blk values."""
            perm = jnp.argsort(p)
            p_s = jnp.take(p, perm)
            v_s = jnp.take(v, perm)
            ok = p_s < BIG
            dest = jnp.clip(p_s // blk, 0, d - 1).astype(jnp.int32)
            send_sz = jnp.sum(
                (dest[:, None] == srcs_axis[None, :]) & ok[:, None],
                axis=0, dtype=jnp.int32,
            )
            in_off = jnp.cumsum(send_sz, dtype=jnp.int32) - send_sz
            S = jax.lax.all_gather(send_sz, AXIS)           # [sender, dest]
            out_off = jnp.take(
                jnp.cumsum(S, axis=0, dtype=jnp.int32) - S, me, axis=0
            )
            recv_sz = S[:, me]
            p_r = exchange(p_s, jnp.full(blk, BIG, pos_dtype),
                           in_off, send_sz, out_off, recv_sz)
            fillv = jnp.asarray(fill, v.dtype)
            v_r = exchange(v_s, jnp.full(blk, fillv),
                           in_off, send_sz, out_off, recv_sz)
            slot = jnp.where(p_r < BIG, p_r - pos0, blk).astype(jnp.int32)
            return jnp.full(blk, fillv).at[slot].set(v_r, mode="drop")

        def dist_gather(q, vals, fill):
            """out[i] = vals_global[q[i]] for valid i (q a permutation of
            the valid element ids); two dist_scatters (request, reply)."""
            qm = jnp.where(valid, q, BIG)
            req = dist_scatter(qm, gid, BIG)         # owner slot -> requester
            return dist_scatter(req, vals, fill)     # requester <- owner val

        # ---- prep: per-(source, symbol) count cube -> fsym, rank0, psi ----
        local_cnt = jnp.zeros((ns, VC_LEN), jnp.int32)
        excl = jnp.zeros(blk, pos_dtype)             # in-device (src,sym) rank
        for s in range(ns):
            for c in range(VC_LEN):
                m = valid & (src_l == s) & (syms_l == c)
                local_cnt = local_cnt.at[s, c].set(
                    jnp.sum(m, dtype=jnp.int32)
                )
                e = jnp.cumsum(m.astype(pos_dtype)) - m.astype(pos_dtype)
                excl = jnp.where(m, e, excl)
        cube = jax.lax.all_gather(local_cnt, AXIS)   # [D, ns, 6]
        dev_pref = (jnp.cumsum(cube, axis=0, dtype=jnp.int32) - cube)[me]
        totals = jnp.sum(cube, axis=0).astype(pos_dtype)        # [ns, 6]
        src_csum = jnp.concatenate(
            [jnp.zeros((ns, 1), pos_dtype), jnp.cumsum(totals, axis=1)],
            axis=1,
        )                                                        # [ns, 7]
        off = jnp.concatenate(
            [jnp.zeros(1, pos_dtype),
             jnp.cumsum(jnp.sum(totals, axis=1))]
        )                                                        # [ns+1]
        sym_tot = jnp.sum(totals, axis=0)                        # [6]
        sym_pref = jnp.concatenate(
            [jnp.zeros(1, pos_dtype), jnp.cumsum(sym_tot)]
        )                                                        # [7]

        src_c = jnp.clip(src_l, 0, ns - 1)
        sym_c = jnp.clip(syms_l, 0, VC_LEN - 1)
        # F-column symbol of my rows: f = in-source row, fsym by C_s bounds
        f = gid - jnp.take(off, src_c)
        bounds = jnp.take(src_csum, src_c, axis=0)               # [blk, 7]
        fsym = jnp.sum(
            f[:, None] >= bounds[:, 1:VC_LEN], axis=1, dtype=jnp.int32
        )
        rank0 = jnp.where(valid, jnp.take(sym_pref, fsym), BIG)
        # LF(e) = off_s + C_s[sym] + global in-(source,symbol) rank
        lf = (
            jnp.take(off, src_c)
            + src_csum[src_c, sym_c]
            + dev_pref[src_c, sym_c].astype(pos_dtype)
            + excl
        )
        psi_r = dist_scatter(jnp.where(valid, lf, BIG), gid, BIG)
        psi = jnp.where(valid, psi_r, gid)

        # ---- one distributed PSRS pass: sort by (k1, k2, gid) ----
        def sort_pass(k1, k2, want_perm):
            k1m = jnp.where(valid, k1, BIG)
            k2m = jnp.where(valid, k2, BIG)
            k1s, k2s, gs = jax.lax.sort((k1m, k2m, gid), num_keys=3)
            samp = ((jnp.arange(d) * blk) // d).astype(jnp.int32)
            S1 = jax.lax.all_gather(jnp.take(k1s, samp), AXIS).reshape(-1)
            S2 = jax.lax.all_gather(jnp.take(k2s, samp), AXIS).reshape(-1)
            S3 = jax.lax.all_gather(jnp.take(gs, samp), AXIS).reshape(-1)
            S1, S2, S3 = jax.lax.sort((S1, S2, S3), num_keys=3)
            spi = (jnp.arange(1, d) * d).astype(jnp.int32)
            sp1, sp2, sp3 = (jnp.take(a, spi) for a in (S1, S2, S3))
            le = (
                (sp1[None, :] < k1s[:, None])
                | ((sp1[None, :] == k1s[:, None])
                   & ((sp2[None, :] < k2s[:, None])
                      | ((sp2[None, :] == k2s[:, None])
                         & (sp3[None, :] <= gs[:, None]))))
            )
            dest = jnp.sum(le, axis=1, dtype=jnp.int32)          # [blk]
            send_sz = jnp.sum(
                dest[:, None] == srcs_axis[None, :], axis=0, dtype=jnp.int32
            )
            in_off = jnp.cumsum(send_sz, dtype=jnp.int32) - send_sz
            S = jax.lax.all_gather(send_sz, AXIS)
            out_off = jnp.take(
                jnp.cumsum(S, axis=0, dtype=jnp.int32) - S, me, axis=0
            )
            recv_sz = S[:, me]
            k1_r = exchange(k1s, jnp.full(cap, BIG, pos_dtype),
                            in_off, send_sz, out_off, recv_sz)
            k2_r = exchange(k2s, jnp.full(cap, BIG, pos_dtype),
                            in_off, send_sz, out_off, recv_sz)
            g_r = exchange(gs, jnp.full(cap, BIG, pos_dtype),
                           in_off, send_sz, out_off, recv_sz)
            k1o, k2o, go = jax.lax.sort((k1_r, k2_r, g_r), num_keys=3)

            nval = jnp.sum(k1o < BIG, dtype=jnp.int32)
            V = jax.lax.all_gather(nval, AXIS)                   # [D]
            goff = jnp.sum(
                jnp.where(srcs_axis < me, V, 0), dtype=pos_dtype
            )
            okm = jnp.arange(cap, dtype=jnp.int32) < nval
            # group starts: (k1, k2) change points, device edge via the
            # previous non-empty device's last key
            last_i = jnp.clip(nval - 1, 0, cap - 1)
            l1 = jnp.take(k1o, last_i)
            l2 = jnp.take(k2o, last_i)
            has = (nval > 0).astype(jnp.int32)
            P1 = jax.lax.all_gather(l1, AXIS)
            P2 = jax.lax.all_gather(l2, AXIS)
            HA = jax.lax.all_gather(has, AXIS)
            elig = (srcs_axis < me) & (HA > 0)
            pidx = jnp.max(jnp.where(elig, srcs_axis, -1))
            pc = jnp.clip(pidx, 0, d - 1)
            first_new = (
                (pidx < 0)
                | (k1o[0] != P1[pc])
                | (k2o[0] != P2[pc])
            )
            neq = jnp.concatenate(
                [first_new[None],
                 (k1o[1:] != k1o[:-1]) | (k2o[1:] != k2o[:-1])]
            )
            gpos = goff + jnp.arange(cap, dtype=pos_dtype)
            starts = jnp.where(neq & okm, gpos, -1)
            run_start = jax.lax.cummax(starts)
            lastc = jnp.max(starts)
            LC = jax.lax.all_gather(lastc, AXIS)
            carry = jnp.max(
                jnp.where(srcs_axis < me, LC, jnp.asarray(-1, pos_dtype))
            )
            rank_sorted = jnp.maximum(run_start, carry)
            p_back = jnp.where(okm, go, BIG)
            new_rank = dist_scatter(p_back, rank_sorted, BIG)
            new_rank = jnp.where(valid, new_rank, BIG)
            if not want_perm:
                return new_rank, None
            # merged-position permutation: merged slot gpos holds element go
            perm = dist_scatter(jnp.where(okm, gpos, BIG), go, BIG)
            return new_rank, perm

        def cond(carry):
            return carry[2]

        def body(carry):
            rank, succ, _ = carry
            rank_ahead = dist_gather(succ, rank, BIG)
            new_rank, _ = sort_pass(rank, rank_ahead, False)
            ch = jnp.any((new_rank != rank) & valid)
            changed = jax.lax.psum(ch.astype(jnp.int32), AXIS) > 0
            succ2 = dist_gather(succ, succ, BIG)
            succ2 = jnp.where(valid, succ2, gid)
            return new_rank, succ2, changed

        # rank0 (position-style rank by first rotation symbol) needs no
        # sort: it is the global symbol-count prefix at fsym
        rank, _, _ = jax.lax.while_loop(
            cond, body, (rank0, psi, jnp.bool_(True))
        )
        # final order: sort by converged rank, gid tiebreak (= source-major)
        _, perm = sort_pass(rank, rank, True)
        permc = jnp.where(valid, perm, gid)
        out_sym = dist_gather(permc, syms_l, jnp.int32(_PAD_SYM))
        out_src = dist_gather(permc, src_l, jnp.int32(ns))
        out_sym = jnp.where(valid, out_sym, _PAD_SYM)
        out_src = jnp.where(valid, out_src, ns)
        return out_sym[None, :], out_src[None, :]

    return shard_map(
        program,
        mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS, None)),
        out_specs=(P(AXIS, None), P(AXIS, None)),
    )(syms, src)


def sharded_doubling_merge(
    parts: list[np.ndarray], mesh: Mesh | None = None,
    transport: str = "auto", force_wide: bool = False,
    return_sources: bool = False,
):
    """Merge D partial BWTs across the mesh in O(log max-period) rounds.

    Result equals ``ops.merge.kway_merge(parts)`` /
    ``sharded_hm_merge(parts)``; per-device memory stays O(n/D). The number
    of sources may differ from the mesh size. ``transport`` follows
    ``sharded_hm_merge``: the native ragged-all-to-all lowering is opt-in
    (``transport="ragged"`` or ``MSBWT_RAGGED=1``) on non-CPU backends;
    on the CPU the exchanges run through the exact dense simulation.

    >>> import numpy as np
    >>> from msbwt_jax.ops.alphabet import convert_itos, convert_stoi
    >>> from msbwt_jax.utils.oracle import naive_bwt
    >>> parts = [np.asarray(convert_stoi(naive_bwt(g)), np.uint8)
    ...          for g in (["ACGT", "TTT"], ["GGAA"])]
    >>> merged = sharded_doubling_merge(parts)
    >>> convert_itos(merged) == naive_bwt(["ACGT", "TTT", "GGAA"])
    True
    """
    if mesh is None:
        mesh = default_mesh()
    d = mesh.devices.size
    parts = [np.asarray(p, dtype=np.uint8) for p in parts]
    lens = np.array([p.size for p in parts], dtype=np.int32)
    ns = len(parts)
    n = int(lens.sum())
    if n == 0:
        out = np.zeros(0, np.uint8)
        return (out, np.zeros(0, np.int32)) if return_sources else out
    blk = -(-n // d)
    syms = np.full(d * blk, _PAD_SYM, np.int32)
    src = np.full(d * blk, ns, np.int32)
    syms[:n] = np.concatenate([p for p in parts if p.size])
    src[:n] = np.concatenate(
        [np.full(sz, i, np.int32) for i, sz in enumerate(lens) if sz]
    )
    # int32 must hold the drop/fill sentinel BIG = d*blk (> n for ragged
    # inputs), not just n itself — gate wide mode on the sentinel value.
    wide = force_wide or (d * blk) >= 2**31
    backend = jax.default_backend()
    native = backend != "cpu" and (
        transport == "ragged" or os.environ.get("MSBWT_RAGGED", "") == "1"
    )
    multiproc = jax.process_count() > 1

    def to_mesh(host2d):
        if not multiproc:
            return jnp.asarray(host2d)
        # multi-process: every process holds the same full host array
        # (rehearsal-scale contract); hand each its local device rows
        from jax.sharding import NamedSharding

        local = np.asarray([
            i for i, dv in enumerate(mesh.devices.flat)
            if dv.process_index == jax.process_index()
        ])
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, jax.sharding.PartitionSpec(AXIS, None)),
            host2d[local], host2d.shape,
        )

    with jax.enable_x64(wide):
        out_sym, out_src = _doubling_sharded_impl(
            to_mesh(syms.reshape(d, blk)),
            to_mesh(src.reshape(d, blk)),
            n=n, blk=blk, d=d, ns=ns, mesh=mesh, native=native, wide=wide,
        )
        if multiproc:
            from jax.experimental import multihost_utils

            out_sym = multihost_utils.process_allgather(out_sym, tiled=True)
            out_src = multihost_utils.process_allgather(out_src, tiled=True)
        merged = np.asarray(out_sym).reshape(-1)[:n].astype(np.uint8)
        srcs = np.asarray(out_src).reshape(-1)[:n]
    return (merged, srcs) if return_sources else merged
