"""K-mer prefix-range cache: seeded queries equal uncached queries.

Realizes the caching idea the reference sketches but never ships
(ref: src/msbwt_core.rs:133-146).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from msbwt_jax.models.rle_bwt import RleBWT
from msbwt_jax.ops.alphabet import convert_stoi
from msbwt_jax.ops.bcr import build_msbwt, encode_reads
from msbwt_jax.ops.rank import build_kmer_cache, build_occ_index, count_kmers
from msbwt_jax.ops.rle import bytes_from_runs, runs_from_symbols
from msbwt_jax.utils.oracle import naive_bwt


@pytest.fixture(scope="module")
def setup(module_rng):
    rng = module_rng
    data = ["".join(rng.choice(list("ACGNT"), size=25)) for _ in range(60)]
    reads, lengths = encode_reads([convert_stoi(s) for s in data])
    decoded = build_msbwt(reads, lengths)
    index = build_occ_index(jnp.asarray(decoded))
    return data, decoded, index


@pytest.mark.parametrize("cache_k", [1, 2, 4])
def test_cache_table_matches_uncached(setup, rng, cache_k):
    data, decoded, index = setup
    cache = build_kmer_cache(index.bwt, index.occ, index.starts, index.n, cache_k)
    # every code's range must equal an uncached search of that exact string
    n_codes = 6 ** cache_k
    codes = np.arange(n_codes)
    digits = np.stack(
        [(codes // (6 ** (cache_k - 1 - j))) % 6 for j in range(cache_k)], axis=1
    ).astype(np.uint8)
    counts = count_kmers(index, digits)
    tab = np.asarray(cache.table)
    assert (tab[:, 1] - tab[:, 0]).tolist() == counts.tolist()


def test_cached_queries_match(setup, rng):
    data, decoded, index = setup
    cache = build_kmer_cache(index.bwt, index.occ, index.starts, index.n, 4)
    B, K = 500, 12
    kmers = rng.integers(0, 6, size=(B, K)).astype(np.uint8)
    lens = rng.integers(1, K + 1, B).astype(np.int32)
    # right-align (zero the unused prefix so padding is consistent)
    for i in range(B):
        kmers[i, : K - lens[i]] = 0
    plain = count_kmers(index, kmers, lens)
    cached = count_kmers(index, kmers, lens, cache=cache, cache_k=4)
    assert plain.tolist() == cached.tolist()


def test_model_level_cache(setup):
    data, decoded, index = setup
    bwt = RleBWT()
    bwt.load_vector(bytes_from_runs(*runs_from_symbols(decoded)))
    queries = [convert_stoi(s[:10]) for s in data[:20]]
    kmers = np.stack(queries)
    before = bwt.count_kmers(kmers)
    bwt.enable_kmer_cache(cache_k=5)
    after = bwt.count_kmers(kmers)
    assert before.tolist() == after.tolist()
    # sanity vs oracle substring counts
    text = naive_bwt(data)
    assert all(c >= 1 for c in after.tolist())


def test_cache_cleared_on_reload(setup, rng):
    """Regression: loading a new BWT after enable_kmer_cache must NOT serve
    ranges from the old BWT (round-1 bug: _standard_init kept _kmer_cache)."""
    data, decoded, index = setup
    bwt = RleBWT()
    bwt.load_vector(bytes_from_runs(*runs_from_symbols(decoded)))
    bwt.enable_kmer_cache(cache_k=4)
    kmers = np.stack([convert_stoi(s[:10]) for s in data[:10]])
    _ = bwt.count_kmers(kmers)  # exercise the cached path on BWT A

    # now load a DIFFERENT BWT into the same object
    data_b = ["".join(rng.choice(list("ACGT"), size=18)) for _ in range(25)]
    from msbwt_jax.utils.oracle import naive_bwt as _nb
    dec_b = convert_stoi(_nb(data_b))
    bwt.load_vector(bytes_from_runs(*runs_from_symbols(np.asarray(dec_b, np.uint8))))
    q = np.stack([convert_stoi(s[:8]) for s in data_b[:10]])
    counts = bwt.count_kmers(q)
    # every queried 8-mer is a substring of data_b, so counts must be >= 1
    # AND must equal a fresh engine's counts on the same data
    fresh = RleBWT()
    fresh.load_vector(bytes_from_runs(*runs_from_symbols(np.asarray(dec_b, np.uint8))))
    assert counts.tolist() == fresh.count_kmers(q).tolist()
    assert all(c >= 1 for c in counts.tolist())


def test_fused_cache_equals_chained_levels(setup):
    """The fused single-program builder must equal the per-level chain it
    replaced (the chain is still the >6^8 deep-cache continuation, seeded
    from the fused level-8 table — this pins the seam)."""
    import jax.numpy as jnp

    from msbwt_jax.ops.rank import _cache_fused_impl, _cache_level_impl

    data, decoded, index = setup
    k = 5
    lo = jnp.zeros(1, jnp.int32)
    hi = jnp.full(1, int(index.n), jnp.int32)
    for level in range(1, k + 1):
        lo, hi = _cache_level_impl(
            index.bwt, index.occ, index.starts, index.n,
            lo, hi, size=6 ** (level - 1),
        )
    flo, fhi = _cache_fused_impl(index.bwt, index.occ, index.starts, index.n,
                                 cache_k=k)
    assert np.array_equal(np.asarray(flo), np.asarray(lo))
    assert np.array_equal(np.asarray(fhi), np.asarray(hi))


def test_auto_cache_on_big_index(setup, monkeypatch):
    """Indexes past PAIR_AUTO_MIN_SYMBOLS auto-build both the pair index and
    the CACHE_AUTO_K prefix cache; MSBWT_NO_CACHE opts out of the cache
    while keeping the pair index (ref engine always queries cold:
    src/rle_bwt.rs:202-287)."""
    data, decoded, index = setup
    payload = bytes_from_runs(*runs_from_symbols(np.asarray(decoded, np.uint8)))
    kmers = np.stack([convert_stoi(s[:8]) for s in data[:12]])

    baseline = RleBWT()
    baseline.load_vector(payload)
    expect = baseline.count_kmers(kmers).tolist()

    monkeypatch.setattr(RleBWT, "PAIR_AUTO_MIN_SYMBOLS", 1)
    monkeypatch.setattr(RleBWT, "CACHE_AUTO_K", 3)

    bwt = RleBWT()
    bwt.load_vector(payload)
    assert bwt.count_kmers(kmers).tolist() == expect
    assert bwt._pair_index is not None
    assert bwt._cache_k == 3

    monkeypatch.setenv("MSBWT_NO_CACHE", "1")
    bwt2 = RleBWT()
    bwt2.load_vector(payload)
    assert bwt2.count_kmers(kmers).tolist() == expect
    assert bwt2._pair_index is not None
    assert not bwt2._cache_k


def test_auto_cache_dynamic(setup, monkeypatch):
    """DynamicBWT gets the same auto cache+pair treatment on big indexes."""
    from msbwt_jax.models.dynamic import DynamicBWT

    data, decoded, index = setup
    payload = bytes_from_runs(*runs_from_symbols(np.asarray(decoded, np.uint8)))
    kmers = np.stack([convert_stoi(s[:8]) for s in data[:12]])

    baseline = RleBWT()
    baseline.load_vector(payload)
    expect = baseline.count_kmers(kmers).tolist()

    monkeypatch.setattr(RleBWT, "PAIR_AUTO_MIN_SYMBOLS", 1)
    monkeypatch.setattr(RleBWT, "CACHE_AUTO_K", 2)

    dyn = DynamicBWT()
    dyn.load_vector(payload)
    assert dyn.count_kmers(kmers).tolist() == expect
    assert dyn._cache_k == 2
