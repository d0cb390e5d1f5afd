"""Data-parallel MSBWT construction over a device mesh.

Reads are globally sorted, split into contiguous per-device chunks, and every
device builds the BWT of its chunk simultaneously (one ``shard_map`` over the
BCR core — no collectives needed during the per-shard build). The per-shard
partial BWTs are then combined with the Holt–McMillan interleave merge
(``ops.merge``): a binary merge tree, each level an on-device fixpoint.

Because sorted construction is order-independent (SURVEY.md §2) and the H-M
merge is exact on rotation order, the result is identical to a single-device
build — verified against the naive oracle in tests. The merge tree currently
runs level-by-level on one device; distributing the interleave refinement
itself (alltoall scatter of counting-sort targets) is the planned next step
for pod-scale builds.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from msbwt_jax.ops.alphabet import VC_LEN
from msbwt_jax.ops.bcr import bcr_insert_core, reads_to_cols, sort_reads
from msbwt_jax.ops.merge import kway_merge
from msbwt_jax.parallel.mesh import AXIS, default_mesh

_PAD_SYMBOL = 7


@functools.partial(jax.jit, static_argnames=("n_cap", "L", "mesh"))
def _shardwise_bcr(cols_sh, lengths_sh, *, n_cap, L, mesh):
    """[D, L+2, Nl] read cols (length -1 == padding row) -> [D, n_cap] BWTs."""

    def program(cols_blk, lengths_blk):
        cols_l = cols_blk[0]
        lengths_l = lengths_blk[0]
        Nl = cols_l.shape[1]
        valid = lengths_l >= 0
        n_str = jnp.sum(valid.astype(jnp.int32))
        big = jnp.int32(n_cap + BIG_PAD)
        q1 = jnp.where(valid, jnp.cumsum(valid.astype(jnp.int32)) - 1, big)
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


BIG_PAD = 1024  # safely out-of-bounds offset for padding rows' q1


def build_msbwt_sharded(
    reads: np.ndarray, lengths: np.ndarray, mesh: Mesh | None = None,
    merge: str = "tree", force_wide: bool = False, transport: str = "auto",
) -> np.ndarray:
    """Sorted MSBWT of a read collection, built data-parallel over the mesh.

    ``merge="tree"`` combines per-shard BWTs with the single-device binary
    merge tree; ``merge="sharded"`` runs the distributed D-way H-M merge
    (``parallel.sharded_merge``) with the interleave sharded across the mesh.
    Each per-shard build stays int32 (< 2^31 symbols per shard); the merge
    goes int64 ("wide") automatically once the TOTAL passes 2^31 — this is
    the composition that takes chr21-scale (> 2^31 symbol) collections.
    ``force_wide`` exercises the wide merge on small data for tests.
    """
    if mesh is None:
        mesh = default_mesh()
    D = mesh.devices.size
    reads = np.asarray(reads, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    N, L = reads.shape
    if N == 0:
        return np.zeros(0, dtype=np.uint8)
    reads, lengths = sort_reads(reads, lengths)

    Nl = -(-N // D)
    pad = D * Nl - N
    if pad:
        reads = np.vstack([reads, np.zeros((pad, L), np.uint8)])
        lengths = np.concatenate([lengths, np.full(pad, -1, np.int32)])
    lengths_sh = lengths.reshape(D, Nl)
    cols_sh = np.stack([
        reads_to_cols(reads[d * Nl : (d + 1) * Nl], lengths_sh[d])
        for d in range(D)
    ])  # [D, L+2, Nl]

    shard_sizes = np.where(lengths_sh >= 0, lengths_sh + 1, 0).sum(axis=1)
    n_cap = int(shard_sizes.max())
    parts_dev = _shardwise_bcr(
        jnp.asarray(cols_sh), jnp.asarray(lengths_sh), n_cap=n_cap, L=L, mesh=mesh
    )
    parts_np = np.asarray(parts_dev)
    parts = [parts_np[d, : int(shard_sizes[d])] for d in range(D)]
    if merge == "sharded":
        from msbwt_jax.parallel.sharded_merge import sharded_hm_merge

        return sharded_hm_merge(
            parts, mesh=mesh, force_wide=force_wide, transport=transport
        )
    return kway_merge(parts, force_wide=force_wide)
