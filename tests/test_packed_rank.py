"""Parity tests for the packed single-gather rank path vs the baseline
rank engine (itself oracle-validated in test_rle_bwt / test_bcr)."""

import numpy as np
import jax.numpy as jnp

from msbwt_jax.ops.bcr import build_msbwt, encode_reads
from msbwt_jax.ops.packed_rank import (
    count_kmers_packed,
    pack_index,
    rank_packed,
)
from msbwt_jax.ops.rank import (
    build_kmer_cache,
    build_occ_index,
    count_kmers,
    rank,
)


def _index(seed=7, n_reads=60):
    rng = np.random.default_rng(seed)
    reads_l = [rng.integers(1, 6, rng.integers(5, 40)).astype(np.uint8)
               for _ in range(n_reads)]
    reads, lens = encode_reads(reads_l)
    dec = build_msbwt(reads, lens)
    return build_occ_index(jnp.asarray(dec)), rng


def test_rank_parity_all_symbols():
    idx, rng = _index()
    pidx = pack_index(idx)
    n = idx.n
    pos = np.concatenate(
        [np.arange(0, min(n, 260)), rng.integers(0, n + 1, 400), [n]]
    ).astype(np.int32)
    for s in range(6):
        sym = np.full(pos.size, s, np.int32)
        a = np.asarray(rank(idx, jnp.asarray(sym), jnp.asarray(pos)))
        b = np.asarray(rank_packed(pidx.table, jnp.asarray(sym), jnp.asarray(pos)))
        assert np.array_equal(a, b), s


def test_count_kmers_parity_variable_lengths():
    idx, rng = _index(seed=11)
    pidx = pack_index(idx)
    B, K = 200, 8
    klens = rng.integers(1, K + 1, B).astype(np.int32)
    kmers = np.zeros((B, K), np.uint8)
    for i, l in enumerate(klens):
        kmers[i, K - l:] = rng.integers(1, 6, l)
    a = count_kmers(idx, kmers, klens)
    b = count_kmers_packed(pidx, kmers, klens)
    assert np.array_equal(a, b)


def test_count_kmers_parity_with_cache():
    idx, rng = _index(seed=13)
    pidx = pack_index(idx)
    B, K = 150, 7
    klens = rng.integers(1, K + 1, B).astype(np.int32)
    kmers = np.zeros((B, K), np.uint8)
    for i, l in enumerate(klens):
        kmers[i, K - l:] = rng.integers(1, 6, l)
    cache = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 3)
    a = count_kmers(idx, kmers, klens, cache=cache, cache_k=3)
    b = count_kmers_packed(pidx, kmers, klens, cache=cache, cache_k=3)
    assert np.array_equal(a, b)


def test_rank_at_bin_multiple_boundary():
    """Regression: rank(sym, n) with n a multiple of BIN must hit the
    terminal table row, not an out-of-range gather (which fills garbage)."""
    rng = np.random.default_rng(2)
    for n in (128, 256, 4096):
        syms = rng.integers(0, 6, n).astype(np.uint8)
        idx = build_occ_index(jnp.asarray(syms))
        pidx = pack_index(idx)
        for s in range(6):
            want = int((syms == s).sum())
            got = int(rank_packed(pidx.table, jnp.array([s]), jnp.array([n]))[0])
            assert got == want, (n, s)


def test_fetch_counts_compact_and_overflow(monkeypatch):
    """The u16 compact result copy is lossless: small counts ride the half-
    width path; a count past 65535 is detected via the carried max and
    falls back to the full-width copy."""
    import jax.numpy as jnp

    from msbwt_jax.ops import rank as R

    monkeypatch.setattr(R, "_COMPACT_MIN_B", 1)
    # 70,000 'A' symbols: count('A') overflows u16
    dec = np.ones(70_000, np.uint8)
    idx = R.build_occ_index(jnp.asarray(dec))
    kmers = np.array([[1], [2]], np.uint8)
    out = R.count_kmers(idx, kmers)
    assert out.tolist() == [70_000, 0]
    assert out.dtype == np.int64
    # non-overflow batch: compact result equals the full-width result
    monkeypatch.setenv("MSBWT_NO_COMPACT", "1")
    full = R.count_kmers(idx, kmers)
    assert full.tolist() == out.tolist()
