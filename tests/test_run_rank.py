"""Run-length-compressed rank tier (ops.run_rank): parity vs the decoded
rank engine (itself oracle-validated in test_rle_bwt / test_bcr), run-split
boundaries, and memory accounting."""

import numpy as np
import jax.numpy as jnp

from msbwt_jax.ops.bcr import build_msbwt, encode_reads
from msbwt_jax.ops.rank import build_occ_index, build_kmer_cache, count_kmers, rank
from msbwt_jax.ops.rle import runs_from_symbols
from msbwt_jax.ops.run_rank import (
    MAX_RUN,
    RB,
    build_kmer_cache_runs,
    build_run_index,
    build_run_index_from_bytes,
    count_kmers_runs,
    rank_runs,
    _split_runs,
)


def _decoded(seed=7, n_reads=60):
    rng = np.random.default_rng(seed)
    reads_l = [rng.integers(1, 6, rng.integers(5, 40)).astype(np.uint8)
               for _ in range(n_reads)]
    reads, lens = encode_reads(reads_l)
    return np.asarray(build_msbwt(reads, lens)), rng


def _run_index_of(decoded):
    return build_run_index(*runs_from_symbols(decoded))


def test_rank_parity_all_symbols_exhaustive_small():
    dec, _ = _decoded(seed=3, n_reads=12)
    idx = build_occ_index(jnp.asarray(dec))
    ridx = _run_index_of(dec)
    n = idx.n
    pos = np.arange(0, n + 1, dtype=np.int32)  # every position incl. n
    for s in range(6):
        sym = np.full(pos.size, s, np.int32)
        a = np.asarray(rank(idx, jnp.asarray(sym), jnp.asarray(pos)))
        b = np.asarray(rank_runs(ridx.table, ridx.seek, jnp.asarray(sym),
                                 jnp.asarray(pos)))
        assert np.array_equal(a, b), s


def test_rank_parity_random_positions():
    dec, rng = _decoded(seed=7)
    idx = build_occ_index(jnp.asarray(dec))
    ridx = _run_index_of(dec)
    n = idx.n
    pos = np.concatenate(
        [np.arange(0, min(n, 300)), rng.integers(0, n + 1, 500), [n, n]]
    ).astype(np.int32)
    sym = rng.integers(0, 6, pos.size).astype(np.int32)
    a = np.asarray(rank(idx, jnp.asarray(sym), jnp.asarray(pos)))
    b = np.asarray(rank_runs(ridx.table, ridx.seek, jnp.asarray(sym),
                             jnp.asarray(pos)))
    assert np.array_equal(a, b)


def test_long_run_split_parity():
    # runs far beyond the 13-bit cap — split must be transparent
    rng = np.random.default_rng(41)
    pieces = []
    for _ in range(30):
        pieces.append(np.full(rng.integers(1, 3 * MAX_RUN), rng.integers(0, 6),
                              np.uint8))
    dec = np.concatenate(pieces)
    idx = build_occ_index(jnp.asarray(dec))
    ridx = _run_index_of(dec)
    n = idx.n
    pos = np.concatenate(
        [rng.integers(0, n + 1, 600), [0, n]]
    ).astype(np.int32)
    sym = rng.integers(0, 6, pos.size).astype(np.int32)
    a = np.asarray(rank(idx, jnp.asarray(sym), jnp.asarray(pos)))
    b = np.asarray(rank_runs(ridx.table, ridx.seek, jnp.asarray(sym),
                             jnp.asarray(pos)))
    assert np.array_equal(a, b)


def test_split_runs_exact():
    syms = np.array([1, 2, 3], np.uint8)
    lens = np.array([MAX_RUN, MAX_RUN + 1, 2 * MAX_RUN], np.int64)
    s2, l2 = _split_runs(syms, lens)
    assert s2.tolist() == [1, 2, 2, 3, 3]
    assert l2.tolist() == [MAX_RUN, MAX_RUN, 1, MAX_RUN, MAX_RUN]
    assert int(l2.sum()) == int(lens.sum())


def test_count_kmers_parity_variable_lengths():
    dec, rng = _decoded(seed=11)
    idx = build_occ_index(jnp.asarray(dec))
    ridx = _run_index_of(dec)
    B, K = 200, 8
    klens = rng.integers(1, K + 1, B).astype(np.int32)
    kmers = np.zeros((B, K), np.uint8)
    for i, l in enumerate(klens):
        kmers[i, K - l:] = rng.integers(1, 6, l)
    a = count_kmers(idx, kmers, klens)
    b = count_kmers_runs(ridx, kmers, klens)
    assert np.array_equal(a, b)


def test_count_kmers_parity_with_cache():
    dec, rng = _decoded(seed=13)
    idx = build_occ_index(jnp.asarray(dec))
    ridx = _run_index_of(dec)
    cache_k = 3
    cache = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, cache_k)
    rcache = build_kmer_cache_runs(ridx, cache_k)
    assert np.array_equal(np.asarray(cache.lo), np.asarray(rcache.lo))
    assert np.array_equal(np.asarray(cache.hi), np.asarray(rcache.hi))
    B, K = 150, 7
    kmers = rng.integers(0, 6, (B, K)).astype(np.uint8)
    a = count_kmers(idx, kmers)
    b = count_kmers_runs(ridx, kmers, cache=rcache, cache_k=cache_k)
    assert np.array_equal(a, b)


def test_build_from_bytes_matches_build_from_runs():
    from msbwt_jax.ops.rle import bytes_from_runs

    dec, rng = _decoded(seed=17, n_reads=25)
    syms, counts = runs_from_symbols(dec)
    a = build_run_index(syms, counts.astype(np.int64))
    b = build_run_index_from_bytes(bytes_from_runs(syms, counts))
    assert np.array_equal(np.asarray(a.table), np.asarray(b.table))
    assert np.array_equal(np.asarray(a.seek), np.asarray(b.seek))
    assert a.n == b.n


def test_memory_scales_with_runs():
    # highly repetitive input: run tier must be far below 1 byte/position
    dec = np.repeat(np.arange(6, dtype=np.uint8), 50_000)
    ridx = _run_index_of(dec)
    n = dec.size
    bytes_per_pos = ridx.device_bytes() / n
    assert bytes_per_pos < 0.1, bytes_per_pos
    # and queries still answer correctly
    idx = build_occ_index(jnp.asarray(dec))
    kmers = np.array([[1, 1, 1], [2, 3, 4], [5, 5, 5]], np.uint8)
    assert np.array_equal(count_kmers(idx, kmers), count_kmers_runs(ridx, kmers))


def test_empty_and_tiny():
    ridx = build_run_index(np.zeros(0, np.uint8), np.zeros(0, np.int64))
    assert ridx.n == 0
    out = rank_runs(ridx.table, ridx.seek, jnp.asarray([0, 3]),
                    jnp.asarray([0, 0]))
    assert np.asarray(out).tolist() == [0, 0]
    # single run
    ridx1 = build_run_index(np.array([2], np.uint8), np.array([5], np.int64))
    pos = jnp.asarray([0, 1, 4, 5])
    out = rank_runs(ridx1.table, ridx1.seek, jnp.full(4, 2), pos)
    assert np.asarray(out).tolist() == [0, 1, 4, 5]


def test_row_boundary_straddle():
    # adversarial: runs of length exactly 1 so every row covers exactly RB
    # positions and seek windows straddle row boundaries at every offset
    rng = np.random.default_rng(23)
    dec = rng.integers(0, 6, 5 * RB + 17).astype(np.uint8)
    # force alternation so every symbol is its own run
    dec = np.where(np.arange(dec.size) % 2 == 0, dec % 3, 3 + dec % 3).astype(
        np.uint8
    )
    idx = build_occ_index(jnp.asarray(dec))
    ridx = _run_index_of(dec)
    n = dec.size
    pos = np.arange(0, n + 1, dtype=np.int32)
    for s in range(6):
        sym = np.full(pos.size, s, np.int32)
        a = np.asarray(rank(idx, jnp.asarray(sym), jnp.asarray(pos)))
        b = np.asarray(rank_runs(ridx.table, ridx.seek, jnp.asarray(sym),
                                 jnp.asarray(pos)))
        assert np.array_equal(a, b), s
