"""Checks that only a GPU can run: the build's device programs as compiled
for the card, against the plain references. They skip elsewhere; run them
on a card with ``MSBWT_TEST_GPU=1 python -m pytest tests -m gpu -n 0``."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_merge_insert_on_card_matches_reference(gpu_device):
    import jax
    import jax.numpy as jnp

    from msbwt_jax.ops import merge_insert as mi

    rng = np.random.default_rng(0)
    n_old, n_ins = 3_000_000, 300_000
    n_cap = n_old + n_ins
    old = rng.integers(0, 6, n_old).astype(np.int32)
    q = np.sort(rng.choice(n_cap, n_ins, replace=False)).astype(np.int32)
    v = rng.integers(0, 6, n_ins).astype(np.int32)
    old_log = np.full(n_cap, mi._PAD, np.int32)
    old_log[:n_old] = old
    phys = jax.device_put(mi.to_phys(jnp.asarray(old_log), n_cap), gpu_device)
    new, table, m = jax.jit(mi.merge_insert_phys)(
        phys, jnp.asarray(q), jnp.asarray(v), jnp.ones(n_ins, bool))
    want = np.empty(n_cap, np.int32)
    mask = np.ones(n_cap, bool)
    mask[q] = False
    want[q] = v
    want[mask] = old
    assert int(m) == n_ins
    assert np.array_equal(np.asarray(mi.from_phys(new, n_cap)), want)
    flat = np.asarray(new).reshape(-1, 128)
    cnt = np.stack([(flat == s).sum(1) for s in range(6)], 1)
    occ = np.cumsum(cnt, 0) - cnt
    assert np.array_equal(np.asarray(table)[:, :6], occ)


def test_engines_agree_on_card(gpu_device):
    from msbwt_jax.ops.bcr import build_msbwt

    rng = np.random.default_rng(1)
    genome = rng.integers(1, 6, 50_000).astype(np.uint8)
    starts = rng.integers(0, genome.size - 100, 30_000)
    reads = genome[starts[:, None] + np.arange(100)[None, :]]
    lengths = np.full(reads.shape[0], 100, np.int32)
    a = build_msbwt(reads, lengths, engine="xla")
    b = build_msbwt(reads, lengths, engine="fused")
    assert np.array_equal(a, b)
