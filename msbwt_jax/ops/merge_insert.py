"""Merge-insert pass of the fused BCR engine, in plain ``jax.numpy``.

Every BCR construction stage rebuilds the BWT buffer by merging N inserted
symbols into an n-element sequence: ``new[p] = v[i] if p == q[i] else
old[p - #{q <= p}]`` (the batched equivalent of the reference's per-symbol
``RLEBPlusTree::insert_and_count``, ref: src/rle_bplus_tree.rs:210-248).
Here that is one scatter of the N insertions, one integer cumsum for the
shift map and one gather of the old buffer, which XLA fuses with the
elementwise work around them.

The same pass emits the packed rank table of the merged buffer, so the
next stage's rank and the final query indexes need no separate rebuild.

Layouts (read by ``ops.bcr._rank_table`` and
``ops.bcr._derive_indexes_from_phys``):

* phys buffer: int32 ``[rows, 128]``; one front-guard chunk of ``CHUNK``
  PAD symbols, the logical buffer, then three back-guard chunks
  (:func:`phys_rows`). Logical position p lives at flat phys index
  ``p + CHUNK``.
* rank table: int32 ``[rows, TABLE_LANES]``, one row per phys row (a
  128-symbol bin). Lanes 0..5 hold the per-symbol occurrences strictly
  before the row; lane ``PLANE_BASE + 16p + q`` holds byte q of bit-plane
  p (bit m = bit p of the symbol at position 8q+m of the row). PAD (7)
  rows count nothing and set every plane bit.

Every prefix sum is an integer ``jnp.cumsum``, so no count depends on the
device's matmul precision.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

CS = 128                 # rows of 128 symbols per guard chunk
CHUNK = CS * 128
TABLE_LANES = 64
PLANE_BASE = 8           # plane-p byte q lives at lane PLANE_BASE + 16p + q
_PAD = 7


def phys_rows(n_cap: int) -> int:
    """Rows of the phys buffer for a logical capacity of ``n_cap`` symbols:
    1 front-guard chunk + logical region + 3 back-guard chunks."""
    n_chunks_logical = -(-n_cap // CHUNK)
    return (1 + n_chunks_logical + 3) * CS


def to_phys(buf_logical: jax.Array, n_cap: int) -> jax.Array:
    """Embed a logical buffer (flat [n_cap]) into the padded phys layout."""
    rows = phys_rows(n_cap)
    flat = jnp.full(rows * 128, _PAD, jnp.int32)
    flat = jax.lax.dynamic_update_slice(
        flat, buf_logical.astype(jnp.int32), (CHUNK,)
    )
    return flat.reshape(rows, 128)


def from_phys(phys: jax.Array, n_cap: int) -> jax.Array:
    """Extract the logical flat [n_cap] i32 view."""
    return phys.reshape(-1)[CHUNK : CHUNK + n_cap]


def rank_table(phys: jax.Array) -> jax.Array:
    """Packed rank table (module docstring layout) of a phys buffer."""
    rows = phys.shape[0]
    cnt = jnp.sum(
        phys[:, :, None] == jnp.arange(6, dtype=phys.dtype)[None, None, :],
        axis=1, dtype=jnp.int32,
    )                                                     # [rows, 6]
    occ = jnp.cumsum(cnt, axis=0, dtype=jnp.int32) - cnt  # exclusive prefix
    weights = jnp.int32(1) << jnp.arange(8, dtype=jnp.int32)
    planes = [
        jnp.sum(((phys >> p) & 1).reshape(rows, 16, 8) * weights, axis=2,
                dtype=jnp.int32)
        for p in range(3)
    ]
    z2 = jnp.zeros((rows, PLANE_BASE - 6), jnp.int32)
    tail = jnp.zeros((rows, TABLE_LANES - PLANE_BASE - 48), jnp.int32)
    return jnp.concatenate([occ, z2, *planes, tail], axis=1)


def merge_insert_phys(old_phys, q, v, active):
    """One merge-insert pass in phys layout (call under jit).

    ``q``: [N] i32 distinct new-coordinate slots (logical coords);
    ``v``: [N] i32 values in 0..5; ``active``: [N] bool mask.
    Returns (new_phys, table_phys, m): the merged buffer, its packed rank
    table (phys-row-indexed: logical bin b -> row b + CS), and
    m = number of active insertions.
    """
    rows = old_phys.shape[0]
    total = rows * 128
    m = jnp.sum(active.astype(jnp.int32))
    qp = jnp.where(active, q + CHUNK, total)  # phys coords; inactive -> dropped
    ins = jnp.zeros(total, jnp.int8).at[qp].set(
        v.astype(jnp.int8) + 1, mode="drop"
    )
    shift = jnp.cumsum((ins > 0).astype(jnp.int32), dtype=jnp.int32)
    src = jnp.arange(total, dtype=jnp.int32) - shift  # >= 0 for every p
    kept = jnp.take(old_phys.reshape(-1), src, mode="clip")
    new_phys = jnp.where(ins > 0, ins.astype(jnp.int32) - 1, kept)
    new_phys = new_phys.reshape(rows, 128)
    return new_phys, rank_table(new_phys), m
