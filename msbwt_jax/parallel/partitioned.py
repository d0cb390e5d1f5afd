"""Partitioned MSBWT: per-shard BWTs that are never merged.

``count_kmer`` over a read collection is additive across any disjoint
partition of the reads: occurrences of P in the union = sum of occurrences
per part (each k-mer hit lives inside one read). So for counting workloads
— the reference's headline query (ref: src/msbwt_core.rs:124-161) — a
multi-device MSBWT does not need the Holt–McMillan merge at all:

* build: each device runs the BCR core on its contiguous slice of the
  sorted reads (one ``shard_map``, zero collectives) — embarrassingly
  parallel, unlike the merge tree whose refinement rounds cost ~40x a BCR
  stage per element;
* query: every device backward-searches its own shard's index and one
  ``psum`` adds the D partial counts — two collectives per LF step total.

This is the scaling configuration for pod-scale counting (BASELINE.json
configs 4-5). The merged global BWT (``sharded_build`` + ``sharded_merge``)
remains the path for byte-identical ``comp_msbwt.npy`` export and
position-space operations.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from msbwt_jax.ops.alphabet import VC_LEN
from msbwt_jax.ops.bcr import bcr_insert_core, reads_to_cols, sort_reads
from msbwt_jax.ops.rank import BIN
from msbwt_jax.parallel.mesh import AXIS, default_mesh

_PAD_SYMBOL = 7


class PartitionedIndex(NamedTuple):
    """Per-device BWT shards + per-shard packed rank tables (never merged)."""

    table: jax.Array    # int32 [D, SB+1, 32] per-shard packed rank rows
    starts: jax.Array   # int32 [D, VC_LEN + 1] per-shard C arrays
    sizes: jax.Array    # int32 [D] true per-shard BWT lengths
    mesh: Mesh


@functools.partial(jax.jit, static_argnames=("n_cap", "L", "mesh"))
def _partitioned_bcr(cols_sh, lengths_sh, *, n_cap, L, mesh):
    def program(cols_blk, lengths_blk):
        cols_l = cols_blk[0]
        lengths_l = lengths_blk[0]
        valid = lengths_l >= 0
        n_str = jnp.sum(valid.astype(jnp.int32))
        # padding rows (length -1) never insert; park their slot out of range
        q1 = jnp.where(valid, jnp.cumsum(valid.astype(jnp.int32)) - 1,
                       jnp.int32(n_cap + 1024))
        out = bcr_insert_core(
            jnp.zeros(0, jnp.uint8),
            q1,
            cols_l,
            lengths_l,
            jnp.zeros(VC_LEN, jnp.int32),
            n0=0,
            n_cap=n_cap,
            L=L,
            n_strings_total=n_str,
        )
        return out[None, :]

    return shard_map(
        program,
        mesh=mesh,
        in_specs=(P(AXIS, None, None), P(AXIS, None)),
        out_specs=P(AXIS, None),
    )(cols_sh, lengths_sh)


def build_partitioned(
    reads: np.ndarray, lengths: np.ndarray, mesh: Mesh | None = None
) -> PartitionedIndex:
    """Build a partitioned MSBWT: reads sorted globally, split into D
    contiguous groups, one BWT per device, per-shard occ tables."""
    if mesh is None:
        mesh = default_mesh()
    D = mesh.devices.size
    reads = np.asarray(reads, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    N, L = reads.shape
    if N == 0:
        raise ValueError("empty read collection")
    reads, lengths = sort_reads(reads, lengths)

    Nl = -(-N // D)
    pad = D * Nl - N
    if pad:
        reads = np.vstack([reads, np.zeros((pad, L), np.uint8)])
        lengths = np.concatenate([lengths, np.full(pad, -1, np.int32)])
    lengths_sh = lengths.reshape(D, Nl)
    cols_sh = np.stack(
        [reads_to_cols(reads[d * Nl : (d + 1) * Nl], lengths_sh[d])
         for d in range(D)]
    )
    sizes = np.where(lengths_sh >= 0, lengths_sh + 1, 0).sum(axis=1)
    n_cap = -(-int(sizes.max()) // BIN) * BIN  # BIN-align every shard

    parts = np.asarray(_partitioned_bcr(
        jnp.asarray(cols_sh), jnp.asarray(lengths_sh), n_cap=n_cap, L=L,
        mesh=mesh,
    ))
    # normalize tails to PAD, then per-shard packed rank tables + C arrays
    # (one host pass; layout == ops.packed_rank incl. the terminal row)
    pos = np.arange(n_cap)[None, :]
    parts = np.where(pos < sizes[:, None], parts, _PAD_SYMBOL).astype(np.uint8)
    SB = n_cap // BIN
    syms = parts.reshape(D, SB, BIN)
    per_bin = (
        syms[:, :, :, None] == np.arange(VC_LEN, dtype=np.uint8)[None, None, None, :]
    ).sum(axis=2, dtype=np.int32)
    occ = np.concatenate(
        [np.zeros((D, 1, VC_LEN), np.int32), np.cumsum(per_bin, axis=1)], axis=1
    )
    totals = occ[:, -1, :]
    starts = np.concatenate(
        [np.zeros((D, 1), np.int32), np.cumsum(totals, axis=1).astype(np.int32)],
        axis=1,
    )
    table = np.zeros((D, SB + 1, 32), np.int32)
    table[:, :, :VC_LEN] = occ
    w = syms.astype(np.int64).reshape(D, SB, 4, 32)
    k32 = (np.int64(1) << np.arange(32, dtype=np.int64))[None, None, None, :]
    for p in range(3):
        words = (((w >> p) & 1) * k32).sum(axis=3)
        table[:, :SB, 8 + 4 * p : 12 + 4 * p] = (
            (words & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        )

    table_dev = jax.device_put(table, NamedSharding(mesh, P(AXIS, None, None)))
    starts_dev = jax.device_put(starts, NamedSharding(mesh, P(AXIS, None)))
    sizes_dev = jax.device_put(sizes.astype(np.int32), NamedSharding(mesh, P(AXIS)))
    return PartitionedIndex(
        table=table_dev, starts=starts_dev, sizes=sizes_dev, mesh=mesh
    )


@functools.partial(jax.jit, static_argnames=("mesh", "wide"))
def _count_partitioned_impl(table, starts, sizes, kmers, lengths, *, mesh,
                            wide=False):
    from msbwt_jax.ops.packed_rank import rank_packed

    def program(table_blk, starts_blk, sizes_blk, kmers_rep, lengths_rep):
        table_loc = table_blk[0]
        starts_loc = starts_blk[0]
        n_loc = sizes_blk[0]
        B, K = kmers_rep.shape

        # lo must be shard-varying like hi (it feeds shard-local ranks)
        lo = jnp.zeros(B, jnp.int32) + (n_loc & 0)
        hi = jnp.full(B, n_loc, jnp.int32)

        def step(t, carry):
            lo, hi = carry
            sym = kmers_rep[:, K - 1 - t].astype(jnp.int32)
            active = t < lengths_rep
            s = jnp.where(active, sym, 0)
            both = rank_packed(
                table_loc, jnp.concatenate([s, s]), jnp.concatenate([lo, hi])
            )
            c = starts_loc[s]
            new_lo, new_hi = c + both[:B], c + both[B:]
            lo = jnp.where(active, new_lo, lo)
            hi = jnp.where(active, new_hi, hi)
            return lo, hi

        lo, hi = jax.lax.fori_loop(0, K, step, (lo, hi))
        # one collective total: D partial counts -> the union's counts.
        # Per-shard counts are < 2^31 (shards are), but the SUM can exceed
        # int32 at pod scale — widen before the psum when requested.
        part = hi - lo
        if wide:
            part = part.astype(jnp.int64)
        return jax.lax.psum(part, AXIS)

    return shard_map(
        program,
        mesh=mesh,
        in_specs=(P(AXIS, None, None), P(AXIS, None), P(AXIS),
                  P(None, None), P(None)),
        out_specs=P(),
    )(table, starts, sizes, kmers, lengths)


def count_kmers_partitioned(index: PartitionedIndex, kmers, lengths=None,
                            wide: bool | None = None):
    """Batched ``count_kmer`` over the partitioned index: per-shard backward
    search (independent, local) + one final psum. Equals the single-BWT
    count for every k-mer without '$' (k-mer hits never span reads).

    >>> import numpy as np
    >>> from msbwt_jax.ops.alphabet import convert_stoi
    >>> reads = np.stack([convert_stoi("ACGT"), convert_stoi("ACCA")])
    >>> idx = build_partitioned(reads, np.array([4, 4], np.int32))
    >>> [int(c) for c in count_kmers_partitioned(
    ...     idx, np.stack([convert_stoi("AC"), convert_stoi("GT")]))]
    [2, 1]
    """
    kmers = np.asarray(kmers, dtype=np.uint8)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    B, K = kmers.shape
    if lengths is None:
        lengths = np.full(B, K, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    act = np.arange(K)[None, :] >= (K - lengths)[:, None]  # right-aligned
    if not np.all(~act | ((kmers > 0) & (kmers < VC_LEN))):
        raise AssertionError("partitioned counting takes k-mers over 1..5 "
                             "($-queries are position-space; use the merged BWT)")
    if wide is None:
        # total collection size decides whether count sums can overflow i32
        wide = bool(np.asarray(index.sizes).astype(np.int64).sum() >= 2**31)
    with jax.enable_x64(wide):
        out = _count_partitioned_impl(
            index.table, index.starts, index.sizes,
            jnp.asarray(kmers), jnp.asarray(lengths),
            mesh=index.mesh, wide=wide,
        )
    return np.asarray(out)
