"""Tests for the merge-insert pass of the fused BCR engine
(``ops.merge_insert``) and the engine itself (parity vs the XLA engine /
naive oracle).

Mirrors the reference's oracle-based strategy (SURVEY.md §4): every construction
path is checked against ``naive_bwt`` or an already-oracle-validated engine.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from msbwt_jax.ops.bcr import build_msbwt, encode_reads
from msbwt_jax.ops.merge_insert import (
    CHUNK,
    _PAD,
    from_phys,
    merge_insert_phys,
    to_phys,
)
from msbwt_jax.utils.oracle import naive_bwt


def _oracle_insert(old, q, v, active):
    q = np.asarray(q)[active]
    v = np.asarray(v)[active]
    order = np.argsort(q)
    q, v = q[order], v[order]
    out = np.full(old.size + q.size, -1, np.int32)
    out[q] = v
    mask = np.ones(out.size, bool)
    mask[q] = False
    out[mask] = old
    return out


def _run(n_old, n_ins, n_cap, seed=0, frac_active=1.0):
    r = np.random.default_rng(seed)
    old = r.integers(0, 6, n_old).astype(np.int32)
    active = r.random(n_ins) < frac_active
    m = int(active.sum())
    q = r.choice(n_old + m, size=n_ins, replace=False).astype(np.int32)
    v = r.integers(0, 6, n_ins).astype(np.int32)
    old_log = np.full(n_cap, _PAD, np.int32)
    old_log[:n_old] = old
    phys = to_phys(jnp.asarray(old_log), n_cap)
    new_phys, _tab, mm = merge_insert_phys(
        phys, jnp.asarray(q), jnp.asarray(v), jnp.asarray(active)
    )
    got = np.asarray(from_phys(new_phys, n_cap))
    want = _oracle_insert(old, q, v, active)
    assert int(mm) == m
    assert np.array_equal(got[: want.size], want)
    assert (got[want.size :] == _PAD).all()


@pytest.mark.parametrize(
    "n_old,n_ins,n_cap",
    [
        (0, 5, 64),
        (10, 1, 64),
        (100, 50, 256),
        (1000, 300, 2000),
        (CHUNK - 1, 3, CHUNK + 64),
        (CHUNK, 64, 2 * CHUNK),
    ],
)
def test_merge_insert_matches_oracle(n_old, n_ins, n_cap):
    _run(n_old, n_ins, n_cap, seed=n_old + n_ins)


def test_merge_insert_masked():
    _run(500, 100, 800, seed=7, frac_active=0.5)


@pytest.mark.parametrize("delta", [-8, 8])
def test_merge_insert_consecutive_run(delta):
    """A run of consecutive insertion slots just under and just over one
    128-symbol row: the shift map grows by one per position across a row
    boundary."""
    r = np.random.default_rng(abs(delta))
    n_ins = 128 + delta
    n_old = 2 * CHUNK
    old = r.integers(0, 6, n_old).astype(np.int32)
    # consecutive slots inside the second logical chunk maximize tloc
    q = (CHUNK + 64 + np.arange(n_ins)).astype(np.int32)
    v = r.integers(0, 6, n_ins).astype(np.int32)
    n_cap = n_old + n_ins
    old_log = np.full(n_cap, _PAD, np.int32)
    old_log[:n_old] = old
    phys = to_phys(jnp.asarray(old_log), n_cap)
    new_phys, _tab, _ = merge_insert_phys(
        phys, jnp.asarray(q), jnp.asarray(v), jnp.ones(n_ins, bool)
    )
    got = np.asarray(from_phys(new_phys, n_cap))
    want = _oracle_insert(old, q, v, np.ones(n_ins, bool))
    assert np.array_equal(got, want)


def test_merge_insert_clustered_full_chunk():
    """600 consecutive insertion slots: several rows made only of
    insertions."""
    r = np.random.default_rng(9)
    n_old, n_ins = 3000, 600
    old = r.integers(0, 6, n_old).astype(np.int32)
    q = (1000 + np.arange(n_ins)).astype(np.int32)
    v = r.integers(0, 6, n_ins).astype(np.int32)
    n_cap = n_old + n_ins
    old_log = np.full(n_cap, _PAD, np.int32)
    old_log[:n_old] = old
    phys = to_phys(jnp.asarray(old_log), n_cap)
    new_phys, _tab, _ = merge_insert_phys(
        phys, jnp.asarray(q), jnp.asarray(v), jnp.ones(n_ins, bool)
    )
    got = np.asarray(from_phys(new_phys, n_cap))
    want = _oracle_insert(old, q, v, np.ones(n_ins, bool))
    assert np.array_equal(got, want)


def test_bcr_fused_engine_matches_naive():
    from msbwt_jax.ops.alphabet import convert_itos

    r = np.random.default_rng(42)
    reads_l = [r.integers(1, 6, r.integers(1, 25)).astype(np.uint8) for _ in range(12)]
    reads, lengths = encode_reads(reads_l)
    got = build_msbwt(reads, lengths, sorted_insert=True, engine="fused")
    assert convert_itos(got) == naive_bwt([convert_itos(s) for s in reads_l])


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_bcr_fused_engine_matches_xla(sorted_insert):
    r = np.random.default_rng(3)
    reads_l = [r.integers(1, 6, r.integers(1, 30)).astype(np.uint8) for _ in range(20)]
    reads, lengths = encode_reads(reads_l)
    a = build_msbwt(reads, lengths, sorted_insert, engine="xla")
    b = build_msbwt(reads, lengths, sorted_insert, engine="fused")
    assert np.array_equal(a, b)


def test_bcr_fused_extend_matches_xla():
    r = np.random.default_rng(5)
    base_l = [r.integers(1, 6, 12).astype(np.uint8) for _ in range(6)]
    base_reads, base_lens = encode_reads(base_l)
    base = build_msbwt(base_reads, base_lens, True, engine="xla")
    new_l = [r.integers(1, 6, 9).astype(np.uint8) for _ in range(4)]
    new_reads, new_lens = encode_reads(new_l)
    a = build_msbwt(new_reads, new_lens, True, base=base, base_string_count=6,
                    engine="xla")
    b = build_msbwt(new_reads, new_lens, True, base=base, base_string_count=6,
                    engine="fused")
    assert np.array_equal(a, b)


def test_fused_table_matches_reference_layout():
    """The fused rank table must equal an independently computed
    occ-prefix + byte packing of the merged buffer."""
    from msbwt_jax.ops.merge_insert import CS, PLANE_BASE

    r = np.random.default_rng(11)
    n_old, n_ins = 900, 200
    old = r.integers(0, 6, n_old).astype(np.int32)
    q = r.choice(n_old + n_ins, size=n_ins, replace=False).astype(np.int32)
    v = r.integers(0, 6, n_ins).astype(np.int32)
    n_cap = n_old + n_ins + 37  # ragged tail exercises PAD rows
    old_log = np.full(n_cap, _PAD, np.int32)
    old_log[:n_old] = old
    phys = to_phys(jnp.asarray(old_log), n_cap)
    new_phys, tab, _ = merge_insert_phys(
        phys, jnp.asarray(q), jnp.asarray(v), jnp.ones(n_ins, bool),
    )
    merged_phys = np.asarray(new_phys)  # [rows, 128], includes guards
    tab = np.asarray(tab)
    rows = merged_phys.shape[0]
    # reference: occ lanes = per-symbol counts strictly before each phys row
    flat = merged_phys.reshape(-1)
    for row in range(CS, rows - 2 * CS):  # logical region
        before = flat[: row * 128]
        for s in range(6):
            assert tab[row, s] == np.count_nonzero(before == s), (row, s)
        # qwords: plane p, word j packs bits of positions 8j..8j+7
        win = merged_phys[row]
        for p in range(3):
            for j in range(16):
                want = sum(
                    ((int(win[8 * j + i]) >> p) & 1) << i for i in range(8)
                )
                assert tab[row, PLANE_BASE + 16 * p + j] == want, (row, p, j)
