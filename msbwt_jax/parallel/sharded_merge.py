"""Distributed D-way Holt–McMillan merge over a device mesh.

Generalizes the pairwise interleave refinement (ref: src/bwt_util.rs:21-141)
to D partial BWTs merged simultaneously, with the interleave vector sharded
by merged position across the mesh. Each refinement round is one SPMD
program:

  1. every device reconstructs the merged symbol stream for its block —
     cross-shard source offsets come from an ``all_gather`` of the [D, D]
     per-block source-count matrix (device-major exclusive prefix),
  2. the stable counting sort of the interleave by symbol is computed from an
     ``all_gather`` of per-block per-symbol counts ([D, 6]), giving every
     element an exact global target position,
  3. the permutation is applied with a scatter into a full-length zero
     buffer + ``psum`` (an all-to-all in disguise; see "scaling note"),
  4. convergence is a ``psum``-reduced any-changed flag driving one
     ``lax.while_loop`` — at most max-rotation-period rounds
     (ref fixpoint: src/bwt_util.rs:120-124).

The result equals the single-device merge tree (``ops.merge.kway_merge``)
and therefore the sorted single-device build — verified by tests on the
8-virtual-device CPU mesh.

Two transports implement the same math:

* ``dense`` — steps 1 and 3 as full-length ``all_gather``/``psum`` (O(n)
  bytes per device per round). Simple, and the only form XLA:CPU can run.
* ``ragged`` — the scalable pod transport: within any merged block, the
  elements drawn from source j form ONE contiguous run of source-j
  positions, and after the counting sort each block's elements destined for
  block i form ONE contiguous run of the tgt-sorted stream. Both steps are
  therefore single-chunk-per-peer exchanges = ``jax.lax.ragged_all_to_all``:
  per-device traffic per round is exactly its n/D elements (plus two [D, D]
  / [D, 6] ``all_gather``s of counts), and per-device memory is O(n/D) —
  no device ever materializes the other shards. XLA:CPU has no
  ragged-all-to-all kernel, so on CPU meshes the SAME program runs with an
  exact psum-based simulation of the primitive (``_exchange_sim``), which is
  how the 8-virtual-device tests pin ragged == dense == single-device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from msbwt_jax.ops.alphabet import VC_LEN
from msbwt_jax.parallel.mesh import AXIS, default_mesh

_PAD_SRC = 255  # interleave tail padding — must not collide with a source id
_PAD_SYM = 7    # symbol-stream padding (symbols are 0..5)


@functools.partial(
    jax.jit, static_argnames=("n", "blk", "d", "bmax", "mesh", "wide")
)
def _sharded_merge_impl(parts, lens, *, n, blk, d, bmax, mesh, wide=False):
    """parts: [D, Bmax] u8 per-source BWTs; lens: [D] i32 true lengths.
    Returns merged symbols sharded as [D, blk] u8 (PAD past n). ``wide``
    switches global positions to int64 (merged size past 2^31; each SOURCE
    must still fit int32, which D-way sharded construction guarantees)."""
    pos_dtype = jnp.int64 if wide else jnp.int32
    offsets = jnp.concatenate(
        [jnp.zeros(1, pos_dtype), jnp.cumsum(lens.astype(pos_dtype))]
    )

    def program(parts_blk, lens_rep):
        # parts arrive sharded by source id; gather all sources locally
        # (the ragged transport below avoids this O(n) gather)
        parts_all = jax.lax.all_gather(parts_blk, AXIS, tiled=True)  # [D, Bmax]
        me = jax.lax.axis_index(AXIS)
        pos0 = me.astype(pos_dtype) * blk
        gpos = pos0 + jnp.arange(blk, dtype=pos_dtype)
        valid = gpos < n
        srcs = jnp.arange(d, dtype=jnp.int32)

        # initial interleave: position p draws from source j iff
        # offsets[j] <= p < offsets[j+1]
        init = jnp.sum(
            (gpos[:, None] >= offsets[None, 1:]).astype(jnp.int32), axis=1
        ).astype(jnp.uint8)
        init = jnp.where(valid, init, jnp.uint8(_PAD_SRC))

        def reconstruct(inter):
            onehot = inter[:, None] == srcs[None, :].astype(jnp.uint8)  # [blk, D]
            local_counts = jnp.sum(onehot, axis=0, dtype=jnp.int32)     # [D]
            all_counts = jax.lax.all_gather(local_counts, AXIS)         # [D, D]
            start = jnp.cumsum(all_counts, axis=0, dtype=jnp.int32) - all_counts
            my_start = start[me]                                        # [D]
            r_loc = jnp.cumsum(onehot, axis=0, dtype=jnp.int32) - onehot
            src_pos = jnp.sum(jnp.where(onehot, my_start[None, :] + r_loc, 0), axis=1)
            flat = parts_all.reshape(-1)
            g = jnp.clip(
                inter.astype(pos_dtype) * bmax + src_pos.astype(pos_dtype),
                0, d * bmax - 1,
            )
            syms = jnp.take(flat, g)
            return jnp.where(inter == _PAD_SRC, jnp.uint8(_PAD_SYM), syms)

        def refine(inter):
            syms = reconstruct(inter)
            onehot = syms[:, None] == jnp.arange(VC_LEN, dtype=jnp.uint8)[None, :]
            local_counts = jnp.sum(onehot, axis=0, dtype=jnp.int32)       # [6]
            all_counts = jax.lax.all_gather(local_counts, AXIS)          # [D, 6]
            totals = jnp.sum(all_counts, axis=0)
            cvec = jnp.concatenate(
                [jnp.zeros(1, pos_dtype),
                 jnp.cumsum(totals.astype(pos_dtype))[:-1]]
            )
            dev_start = jnp.cumsum(all_counts, axis=0, dtype=jnp.int32) - all_counts
            my_start = dev_start[me]                                     # [6]
            r_loc = jnp.cumsum(onehot, axis=0, dtype=jnp.int32) - onehot
            tgt = jnp.sum(
                jnp.where(
                    onehot,
                    cvec[None, :] + (my_start[None, :] + r_loc).astype(pos_dtype),
                    0,
                ),
                axis=1,
            )
            tgt = jnp.where(
                syms == _PAD_SYM, jnp.asarray(d * blk, pos_dtype), tgt
            )  # dropped
            routed = (
                jnp.zeros(d * blk, jnp.int32)
                .at[tgt]
                .set(inter.astype(jnp.int32) + 1, mode="drop")
            )
            routed = jax.lax.psum(routed, AXIS)
            mine = jax.lax.dynamic_slice(routed, (pos0,), (blk,))
            return jnp.where(valid, (mine - 1).astype(jnp.uint8), jnp.uint8(_PAD_SRC))

        def cond(carry):
            cur, nxt = carry
            changed = jnp.any(cur != nxt)
            return jax.lax.psum(changed.astype(jnp.int32), AXIS) > 0

        def body(carry):
            _, nxt = carry
            return nxt, refine(nxt)

        _, final = jax.lax.while_loop(cond, body, (init, refine(init)))
        merged = reconstruct(final)
        return merged[None, :]

    return shard_map(
        program,
        mesh=mesh,
        in_specs=(P(AXIS, None), P()),
        out_specs=P(AXIS, None),
    )(parts, lens)


# ---------------------------------------------------------------------------
# ragged transport
# ---------------------------------------------------------------------------


def _exchange_native(operand, out, in_off, send_sz, out_off, recv_sz):
    """The real thing: one XLA ragged-all-to-all (non-CPU backends).
    ``out_off`` is sender-side (where my chunk lands in each peer's output),
    matching the primitive's convention."""
    return jax.lax.ragged_all_to_all(
        operand, out, in_off, send_sz, out_off, recv_sz, axis_name=AXIS
    )


def _exchange_sim(operand, out, in_off, send_sz, out_off, recv_sz, *, d):
    """Exact simulation of ``ragged_all_to_all`` with dense collectives, for
    CPU meshes (XLA:CPU has no ragged-all-to-all kernel). Requires what our
    callers guarantee: per-peer input chunks are consecutive ascending
    (``in_off`` = exclusive prefix of ``send_sz``) and received chunks fill a
    prefix of ``out``. Communication here is O(n) — the SIMULATION is dense,
    the program semantics are the ragged ones."""
    out_len = out.shape[0]
    B = operand.shape[0]
    # scatter indices span [0, d*out_len] — widen past 2^31 merged symbols
    idx_dtype = jnp.int64 if d * out_len >= 2**31 else jnp.int32
    k = jnp.arange(B, dtype=jnp.int32)
    # destination peer of element k: chunks are consecutive ascending
    peer = jnp.sum((k[:, None] >= (in_off + send_sz)[None, :]), axis=1,
                   dtype=jnp.int32)
    peer_c = jnp.clip(peer, 0, d - 1)
    within = k - in_off[peer_c]
    valid = (peer < d) & (within < send_sz[peer_c])
    gpos = (peer_c.astype(idx_dtype) * out_len
            + (out_off[peer_c] + within).astype(idx_dtype))
    big = jnp.asarray(d * out_len, idx_dtype)
    routed = (
        jnp.zeros(d * out_len, operand.dtype)
        .at[jnp.where(valid, gpos, big)]
        .set(operand, mode="drop")
    )
    routed = jax.lax.psum(routed, AXIS)
    me = jax.lax.axis_index(AXIS)
    mine = jax.lax.dynamic_slice(routed, (me * out_len,), (out_len,))
    total_recv = jnp.sum(recv_sz)
    filled = jnp.arange(out_len, dtype=jnp.int32) < total_recv
    return jnp.where(filled, mine, out)


@functools.partial(
    jax.jit, static_argnames=("n", "blk", "d", "bmax", "mesh", "native", "wide")
)
def _sharded_merge_ragged_impl(parts, lens, *, n, blk, d, bmax, mesh, native,
                               wide=False):
    """Ragged-transport D-way merge: per-device memory O(n/D); per-round
    traffic = one ragged exchange of the device's own elements (plus [D, D]
    and [D, 6] count gathers). Math identical to ``_sharded_merge_impl``.
    ``wide``: global positions int64 (per-device blocks stay int32)."""
    pos_dtype = jnp.int64 if wide else jnp.int32
    offsets = jnp.concatenate(
        [jnp.zeros(1, pos_dtype), jnp.cumsum(lens.astype(pos_dtype))]
    )
    big = jnp.asarray(d * blk, pos_dtype)

    def exchange(operand, out, in_off, send_sz, out_off, recv_sz):
        # the native primitive requires matching operand/output dtypes; keep
        # the simulation to the same contract so CPU tests catch mismatches
        # (wide mode once paired an int64 operand with an int32 out buffer)
        if operand.dtype != out.dtype:
            raise TypeError(
                f"ragged exchange dtype mismatch: operand {operand.dtype} "
                f"vs out {out.dtype}"
            )
        if native:
            return _exchange_native(operand, out, in_off, send_sz, out_off,
                                    recv_sz)
        return _exchange_sim(operand, out, in_off, send_sz, out_off, recv_sz,
                             d=d)

    def program(parts_blk, lens_rep):
        my_src = parts_blk[0].astype(jnp.int32)  # [bmax] — ONLY my source
        me = jax.lax.axis_index(AXIS)
        pos0 = me.astype(pos_dtype) * blk
        gpos = pos0 + jnp.arange(blk, dtype=pos_dtype)
        valid = gpos < n
        srcs = jnp.arange(d, dtype=jnp.int32)

        init = jnp.sum(
            (gpos[:, None] >= offsets[None, 1:]).astype(jnp.int32), axis=1
        ).astype(jnp.uint8)
        init = jnp.where(valid, init, jnp.uint8(_PAD_SRC))

        def count_matrix(inter):
            onehot = inter[:, None] == srcs[None, :].astype(jnp.uint8)
            local = jnp.sum(onehot, axis=0, dtype=jnp.int32)      # [D srcs]
            C = jax.lax.all_gather(local, AXIS)                   # [blk, src]
            return onehot, C

        def reconstruct(inter):
            """Merged symbols of my block. Within a block the elements from
            source j are one contiguous run of source-j positions, so source
            j ships block i exactly one chunk: [colpref(C)[i, j], C[i, j])."""
            onehot, C = count_matrix(inter)
            col_pref = jnp.cumsum(C, axis=0, dtype=jnp.int32) - C
            in_off = col_pref[:, me]      # my chunks (as source me) per block
            send_sz = C[:, me]
            row_pref = jnp.cumsum(C, axis=1, dtype=jnp.int32) - C
            out_off = row_pref[:, me]     # where my chunk lands per block
            recv_sz = C[me]               # my block's counts per source
            grouped = exchange(
                my_src, jnp.full(blk, _PAD_SYM, jnp.int32),
                in_off, send_sz, out_off, recv_sz,
            )
            # un-group: element p of my block is the r_loc[p]-th element
            # drawn from source inter[p]
            r_loc = jnp.cumsum(onehot, axis=0, dtype=jnp.int32) - onehot
            grp_start = row_pref[me]      # [D]
            src_pos = jnp.sum(
                jnp.where(onehot, grp_start[None, :] + r_loc, 0), axis=1
            )
            syms = jnp.take(grouped, jnp.clip(src_pos, 0, blk - 1))
            return jnp.where(
                inter == _PAD_SRC, jnp.int32(_PAD_SYM), syms
            ).astype(jnp.uint8)

        def refine(inter):
            syms = reconstruct(inter)
            onehot = syms[:, None] == jnp.arange(VC_LEN, dtype=jnp.uint8)[None, :]
            local_counts = jnp.sum(onehot, axis=0, dtype=jnp.int32)
            all_counts = jax.lax.all_gather(local_counts, AXIS)   # [D, 6]
            totals = jnp.sum(all_counts, axis=0)
            cvec = jnp.concatenate(
                [jnp.zeros(1, pos_dtype),
                 jnp.cumsum(totals.astype(pos_dtype))[:-1]]
            )
            dev_start = jnp.cumsum(all_counts, axis=0, dtype=jnp.int32) - all_counts
            my_start = dev_start[me]
            r_loc = jnp.cumsum(onehot, axis=0, dtype=jnp.int32) - onehot
            tgt = jnp.sum(
                jnp.where(
                    onehot,
                    cvec[None, :] + (my_start[None, :] + r_loc).astype(pos_dtype),
                    0,
                ),
                axis=1,
            )
            tgt = jnp.where(syms == _PAD_SYM, big, tgt)
            # tgt-sort my elements: the run destined for each output block is
            # then ONE contiguous chunk of the sorted stream
            perm = jnp.argsort(tgt)
            tgt_s = jnp.take(tgt, perm)
            val_s = jnp.take(inter.astype(jnp.int32), perm)
            dest = jnp.clip(tgt_s // blk, 0, d - 1).astype(jnp.int32)
            send_sz = jnp.sum(
                (dest[:, None] == srcs[None, :]) & (tgt_s < big)[:, None],
                axis=0, dtype=jnp.int32,
            )
            in_off = jnp.cumsum(send_sz, dtype=jnp.int32) - send_sz
            S = jax.lax.all_gather(send_sz, AXIS)  # [sender, dest]
            # sender me's chunk to dest i lands after senders j < me
            out_off = jnp.take(
                jnp.cumsum(S, axis=0, dtype=jnp.int32) - S, me, axis=0
            )
            recv_sz = S[:, me]
            tgt_r = exchange(tgt_s, jnp.full(blk, big, pos_dtype),
                             in_off, send_sz, out_off, recv_sz)
            val_r = exchange(val_s, jnp.full(blk, jnp.int32(_PAD_SRC)),
                             in_off, send_sz, out_off, recv_sz)
            placed = (
                jnp.full(blk, jnp.int32(_PAD_SRC))
                .at[jnp.where(tgt_r < big, tgt_r - pos0, blk).astype(jnp.int32)]
                .set(val_r, mode="drop")
            )
            return jnp.where(valid, placed, jnp.int32(_PAD_SRC)).astype(jnp.uint8)

        def cond(carry):
            cur, nxt = carry
            changed = jnp.any(cur != nxt)
            return jax.lax.psum(changed.astype(jnp.int32), AXIS) > 0

        def body(carry):
            _, nxt = carry
            return nxt, refine(nxt)

        _, final = jax.lax.while_loop(cond, body, (init, refine(init)))
        merged = reconstruct(final)
        return merged[None, :]

    return shard_map(
        program,
        mesh=mesh,
        in_specs=(P(AXIS, None), P()),
        out_specs=P(AXIS, None),
    )(parts, lens)


def sharded_hm_merge(
    parts: list[np.ndarray], mesh: Mesh | None = None,
    transport: str = "auto", force_wide: bool = False,
) -> np.ndarray:
    """Merge D partial BWTs with the interleave sharded across the mesh.

    Result equals ``ops.merge.kway_merge(parts)``. ``transport``:

    * ``"dense"``  — all_gather/psum formulation (O(n)/device/round)
    * ``"ragged"`` — ragged-all-to-all formulation (O(n/D)/device/round;
      the native primitive on GPUs, an exact dense *simulation* of it on
      CPU meshes)
    * ``"auto"``   — dense, unless ``MSBWT_RAGGED=1``. The native ragged
      transport is exact on four H100s but slower there than dense at the
      sizes measured so far (PERF.md), so it stays opt-in.

    >>> import numpy as np
    >>> from msbwt_jax.ops.alphabet import convert_itos, convert_stoi
    >>> from msbwt_jax.utils.oracle import naive_bwt
    >>> a = np.asarray(convert_stoi(naive_bwt(["ACGT"])), np.uint8)
    >>> b = np.asarray(convert_stoi(naive_bwt(["CCA", "TG"])), np.uint8)
    >>> convert_itos(sharded_hm_merge([a, b])) == naive_bwt(
    ...     ["ACGT", "CCA", "TG"])
    True
    """
    import os
    if mesh is None:
        mesh = default_mesh()
    d = mesh.devices.size
    parts = [np.asarray(p, dtype=np.uint8) for p in parts]
    if len(parts) > d:
        raise ValueError(f"at most {d} parts on a {d}-device mesh")
    while len(parts) < d:
        parts.append(np.zeros(0, dtype=np.uint8))
    lens = np.array([p.size for p in parts], dtype=np.int32)
    n = int(lens.sum())
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    bmax = max(1, int(lens.max()))
    packed = np.full((d, bmax), _PAD_SYM, np.uint8)
    for j, p in enumerate(parts):
        packed[j, : p.size] = p
    blk = -(-n // d)
    wide = force_wide or n >= 2**31
    backend = jax.default_backend()
    if transport == "auto":
        opt_in = os.environ.get("MSBWT_RAGGED", "") == "1"
        transport = (
            "ragged" if opt_in and backend != "cpu" else "dense"
        )
    with jax.enable_x64(wide):
        if transport == "dense":
            out = _sharded_merge_impl(
                jnp.asarray(packed), jnp.asarray(lens),
                n=n, blk=blk, d=d, bmax=bmax, mesh=mesh, wide=wide,
            )
        elif transport == "ragged":
            out = _sharded_merge_ragged_impl(
                jnp.asarray(packed), jnp.asarray(lens),
                n=n, blk=blk, d=d, bmax=bmax, mesh=mesh,
                native=backend != "cpu", wide=wide,
            )
        else:
            raise ValueError(f"unknown transport {transport!r}")
    return np.asarray(out).reshape(-1)[:n]
