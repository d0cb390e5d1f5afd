"""Sharded rank index: the BWT and its occurrence checkpoints distributed
across a device mesh, with global rank = psum of per-shard partials.

This is the exact distributed analogue of the reference's
``fm_index[bin] + local scan`` decomposition (ref: src/rle_bwt.rs:204-214):
a rank at global position p = (full counts of every shard left of p's shard)
+ (in-shard rank) — each device computes its contribution from purely local
data and one ``psum`` over the mesh combines them (SURVEY.md §5). K-mer
batches run the whole backward-search loop inside one ``shard_map`` program:
k steps, two psums per step.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from msbwt_jax.ops.alphabet import VC_LEN
from msbwt_jax.ops.rank import BIN
from msbwt_jax.parallel.mesh import AXIS, default_mesh

_PAD_SYMBOL = 7


class ShardedOccIndex(NamedTuple):
    bwt: jax.Array      # uint8 [D, S] — device d holds positions [d*S, (d+1)*S)
    occ: jax.Array      # int32 [D, SB+1, 6] — occ *within shard* before local bin
    starts: jax.Array   # global C array (replicated); int64 when ``wide``
    n: int              # true global BWT length
    shard_len: int      # S
    mesh: Mesh
    wide: bool = False  # int64 global positions (BWTs past 2^31 symbols)


def build_sharded_index(
    decoded, mesh: Mesh | None = None, force_wide: bool = False
) -> ShardedOccIndex:
    """Shard a decoded BWT across the mesh and build per-shard occ tables.

    Global positions switch to int64 ("wide" mode) once the BWT exceeds
    2^31 - 1 symbols — per-shard offsets stay int32 (a shard is < 2^31 by
    construction), so only the [B]-sized position vectors and the C array
    pay the 64-bit emulation cost (ROADMAP "i64 / hi-lo positions").
    ``force_wide`` exercises that path on small data for tests.

    >>> from msbwt_jax.ops.alphabet import convert_stoi
    >>> from msbwt_jax.utils.oracle import naive_bwt
    >>> idx = build_sharded_index(convert_stoi(naive_bwt(["ACGT", "TGCA"])))
    >>> int(count_kmers_sharded(idx, convert_stoi("GT")[None, :])[0])
    1
    """
    if mesh is None:
        mesh = default_mesh()
    decoded = np.asarray(decoded, dtype=np.uint8)
    n = int(decoded.size)
    wide = force_wide or n >= 2**31
    D = mesh.devices.size
    S = -(-max(n, 1) // (D * BIN)) * BIN  # per-shard length, BIN-aligned
    padded = np.full(D * S, _PAD_SYMBOL, dtype=np.uint8)
    padded[:n] = decoded
    bwt_sh = padded.reshape(D, S)
    SB = S // BIN
    per_bin = (
        bwt_sh.reshape(D, SB, BIN)[:, :, :, None]
        == np.arange(VC_LEN, dtype=np.uint8)[None, None, None, :]
    ).sum(axis=2, dtype=np.int32)
    occ_sh = np.concatenate(
        [np.zeros((D, 1, VC_LEN), np.int32), np.cumsum(per_bin, axis=1)], axis=1
    )
    totals = occ_sh[:, -1, :].sum(axis=0, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(totals)])
    starts = starts.astype(np.int64 if wide else np.int32)

    bwt_dev = jax.device_put(bwt_sh, NamedSharding(mesh, P(AXIS, None)))
    occ_dev = jax.device_put(occ_sh, NamedSharding(mesh, P(AXIS, None, None)))
    with jax.enable_x64(wide):
        starts_dev = jax.device_put(starts, NamedSharding(mesh, P()))
    return ShardedOccIndex(
        bwt=bwt_dev, occ=occ_dev, starts=starts_dev, n=n, shard_len=S, mesh=mesh,
        wide=wide,
    )


def shard_local_pos(pos, shard_id, S):
    """Clip global positions into this shard's local [0, S] coordinates.

    ``pos`` may be int64 (wide mode); the shard base ``d*S`` is computed in
    the position dtype — ``axis_index`` is int32 and ``d*S`` exceeds 2^31
    exactly in the wide configs this path exists for (e.g. shard 3 of
    S=805306368 must map pos=3*S+84080896 to 84080896, not wrap negative).
    """
    base_off = shard_id.astype(pos.dtype) * jnp.asarray(S, dtype=pos.dtype)
    return jnp.clip(pos - base_off, 0, S).astype(jnp.int32)


def _local_rank(bwt_loc, occ_loc, S, sym, pos, shard_id):
    """This shard's contribution to a global rank query (vectorized [B]).

    Row gathers + one-hot selects — see ops.rank.rank.
    ``pos`` may be int64 (wide mode); ``shard_local_pos`` maps it into
    int32-safe in-shard coordinates before any gather math.
    """
    loc = shard_local_pos(pos, shard_id, S)
    b = loc // BIN
    window = jnp.take(bwt_loc.reshape(S // BIN, BIN), b, axis=0)
    occ_row = jnp.take(occ_loc, b, axis=0)
    sym_onehot = sym[:, None] == jnp.arange(VC_LEN, dtype=jnp.int32)[None, :]
    base = jnp.sum(occ_row * sym_onehot, axis=1, dtype=jnp.int32)
    in_range = jnp.arange(BIN, dtype=jnp.int32)[None, :] < (loc % BIN)[:, None]
    local = jnp.sum(
        (window == sym[:, None].astype(jnp.uint8)) & in_range, axis=1,
        dtype=jnp.int32,
    )
    return base + local


@functools.partial(jax.jit, static_argnames=("S", "n", "mesh", "wide"))
def _count_kmers_sharded_impl(bwt, occ, starts, kmers, lengths, *, S, n, mesh,
                              wide=False):
    pos_dtype = jnp.int64 if wide else jnp.int32

    def program(bwt_blk, occ_blk, starts_rep, kmers_rep, lengths_rep):
        d = jax.lax.axis_index(AXIS)
        bwt_loc = bwt_blk[0]
        occ_loc = occ_blk[0]
        B, K = kmers_rep.shape

        def rank_g(sym, pos):
            contrib = _local_rank(bwt_loc, occ_loc, S, sym, pos, d)
            # per-shard partials are int32 (< S); the global sum needs the
            # wide dtype once n can exceed 2^31
            return jax.lax.psum(contrib.astype(pos_dtype), AXIS)

        lo = jnp.zeros(B, pos_dtype)
        hi = jnp.full(B, n, pos_dtype)

        def step(t, carry):
            lo, hi = carry
            col = K - 1 - t
            sym = kmers_rep[:, col].astype(jnp.int32)
            active = t < lengths_rep
            sym = jnp.where(active, sym, 0)
            c = starts_rep[sym]
            new_lo = c + rank_g(sym, lo)
            new_hi = c + rank_g(sym, hi)
            lo = jnp.where(active, new_lo, lo)
            hi = jnp.where(active, new_hi, hi)
            return lo, hi

        lo, hi = jax.lax.fori_loop(0, K, step, (lo, hi))
        return hi - lo

    return shard_map(
        program,
        mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS, None, None), P(), P(None, None), P(None)),
        out_specs=P(),
    )(bwt, occ, starts, kmers, lengths)


def count_kmers_sharded(index: ShardedOccIndex, kmers, lengths=None) -> np.ndarray:
    """Batched count_kmer over the sharded index (one SPMD program)."""
    kmers = np.asarray(kmers, dtype=np.uint8)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    if not np.all(kmers < VC_LEN):
        raise AssertionError("k-mer symbols must be < 6")
    B, K = kmers.shape
    if lengths is None:
        lengths = np.full(B, K, dtype=np.int32)
    with jax.enable_x64(index.wide):
        out = _count_kmers_sharded_impl(
            index.bwt, index.occ, index.starts,
            jnp.asarray(kmers), jnp.asarray(np.asarray(lengths, dtype=np.int32)),
            S=index.shard_len, n=index.n, mesh=index.mesh, wide=index.wide,
        )
    return np.asarray(out)
