"""2-step FM index (ops.pair_rank): parity with the single-step engine.

The pair path halves the dependent gather rounds of a query.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from msbwt_jax.ops.alphabet import convert_stoi
from msbwt_jax.ops.pair_rank import (
    _build_pair_stream,
    build_pair_index,
    count_kmers_pair,
)
from msbwt_jax.ops.rank import (
    build_kmer_cache,
    build_occ_index,
    count_kmers,
)
from msbwt_jax.utils.oracle import naive_bwt


@pytest.fixture(scope="module")
def setup(module_rng):
    rng = module_rng
    data = ["".join(rng.choice(list("ACGNT"), size=rng.integers(2, 30)))
            for _ in range(90)]
    dec = np.asarray(convert_stoi(naive_bwt(data)), np.uint8)
    index = build_occ_index(jnp.asarray(dec))
    return dec, index, build_pair_index(index)


def test_pair_stream_is_bwt_and_lf(setup, rng):
    """PS[i] must be (BWT[i] << 3) | BWT[LF(i)] with the true LF."""
    dec, index, pidx = setup
    n = dec.size
    C = np.zeros(7, np.int64)
    for c in dec:
        C[c + 1] += 1
    C = np.cumsum(C)
    occ = np.zeros(6, np.int64)
    lf = np.zeros(n, np.int64)
    for i, c in enumerate(dec):
        lf[i] = C[c] + occ[c]
        occ[c] += 1
    want = (dec.astype(np.int64) << 3) | dec[lf]
    ps = np.asarray(
        _build_pair_stream(index.bwt, index.occ, index.starts, n=index.n)
    )
    assert np.array_equal(ps[:n], want)


def test_pair_stream_rowgather_matches_flat(setup, rng):
    """The i32-packed row-gather stream variant (MSBWT_PAIR_FAST) must
    produce the exact flat-gather stream, including with multiple chunks."""
    from msbwt_jax.ops import pair_rank as pr

    dec, index, pidx = setup
    want = np.asarray(
        pr._build_pair_stream_flat(index.bwt, index.occ, index.starts,
                                   n=index.n)
    )
    got = np.asarray(
        pr._build_pair_stream_rowgather(index.bwt, index.occ, index.starts,
                                        n=index.n)
    )
    assert np.array_equal(got, want)
    # force several chunks: shrink the trace-time chunk cap before the
    # first trace at a fresh shape (jit re-traces per shape, so the
    # patched value is read), then compare on a BWT spanning many bins
    data = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(40)]
    from msbwt_jax.ops.alphabet import convert_stoi as stoi
    dec2 = np.asarray(stoi(naive_bwt(data)), np.uint8)
    idx2 = build_occ_index(jnp.asarray(dec2))
    flat = np.asarray(pr._build_pair_stream_flat(
        idx2.bwt, idx2.occ, idx2.starts, n=idx2.n))
    old = pr._ROWGATHER_CHUNK_BINS
    try:
        pr._ROWGATHER_CHUNK_BINS = 4
        row = np.asarray(pr._build_pair_stream_rowgather(
            idx2.bwt, idx2.occ, idx2.starts, n=idx2.n))
    finally:
        pr._ROWGATHER_CHUNK_BINS = old
    assert np.array_equal(row, flat)


@pytest.mark.parametrize("K", [1, 2, 3, 6, 11, 21])
def test_pair_counts_match_single(setup, rng, K):
    dec, index, pidx = setup
    B = 300
    km = rng.integers(0, 6, size=(B, K)).astype(np.uint8)
    ql = rng.integers(1, K + 1, B).astype(np.int32)
    for i in range(B):
        km[i, : K - ql[i]] = 0
    want = count_kmers(index, km, ql)
    got = count_kmers_pair(pidx, km, ql)
    assert got.tolist() == want.tolist()


def test_pair_counts_with_cache_seed(setup, rng):
    dec, index, pidx = setup
    K, B = 13, 250
    km = rng.integers(0, 6, size=(B, K)).astype(np.uint8)
    ql = rng.integers(1, K + 1, B).astype(np.int32)
    for i in range(B):
        km[i, : K - ql[i]] = 0
    cache = build_kmer_cache(index.bwt, index.occ, index.starts, index.n, 4)
    want = count_kmers(index, km, ql)
    got = count_kmers_pair(pidx, km, ql, cache=cache, cache_k=4)
    assert got.tolist() == want.tolist()


def test_model_level_pair_index(setup, rng):
    """RleBWT.enable_pair_index routes count_kmers through the 2-step path
    with identical results, and reload clears it."""
    from msbwt_jax.models.rle_bwt import RleBWT
    from msbwt_jax.ops.rle import bytes_from_runs, runs_from_symbols

    dec, index, pidx = setup
    bwt = RleBWT()
    bwt.load_vector(bytes_from_runs(*runs_from_symbols(dec)))
    B, K = 100, 9
    km = rng.integers(0, 6, size=(B, K)).astype(np.uint8)
    before = bwt.count_kmers(km)
    bwt.enable_pair_index()
    bwt.enable_kmer_cache(cache_k=4)
    after = bwt.count_kmers(km)
    assert before.tolist() == after.tolist()
    # reload must clear the pair index (stale-state regression family)
    bwt.load_vector(bytes_from_runs(*runs_from_symbols(dec[: dec.size // 2])))
    assert bwt._pair_index is None


def test_compact_row60_layout_matches_legacy(setup, rng, monkeypatch):
    """The 240-byte 60-lane row layout (now the default) must answer
    identically to the legacy 128-lane layout (MSBWT_PAIR_ROW60=0),
    with and without a cache seed, including odd-tail single-symbol
    rounds."""
    dec, index, _ = setup
    monkeypatch.setenv("MSBWT_PAIR_ROW60", "0")
    pidx = build_pair_index(index)       # legacy 128-lane arm
    assert pidx.table2.shape[1] == 128
    monkeypatch.setenv("MSBWT_PAIR_ROW60", "1")
    pidx60 = build_pair_index(index)
    assert pidx60.table2.shape[1] == 60
    kmers = rng.integers(0, 6, size=(300, 7)).astype(np.uint8)
    lengths = rng.integers(1, 8, size=300).astype(np.int32)
    want = count_kmers_pair(pidx, kmers, lengths)
    got = count_kmers_pair(pidx60, kmers, lengths)
    assert np.array_equal(got, want)
    single = count_kmers(index, kmers, lengths)
    assert np.array_equal(got, single)
    cache = build_kmer_cache(index.bwt, index.occ, index.starts, index.n, 2)
    km = rng.integers(0, 6, size=(200, 5)).astype(np.uint8)
    a = count_kmers_pair(pidx60, km, cache=cache, cache_k=2)
    b = count_kmers_pair(pidx, km, cache=cache, cache_k=2)
    assert np.array_equal(a, b)
