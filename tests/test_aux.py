"""Auxiliary subsystems: checkpointing, debug checks, profiling helpers."""

import numpy as np
import pytest

from msbwt_jax.ops.alphabet import convert_stoi
from msbwt_jax.ops.bcr import build_msbwt, encode_reads
from msbwt_jax.ops.rank import build_occ_index, count_kmers
from msbwt_jax.utils import checkpoint, checks
from msbwt_jax.utils.oracle import naive_bwt
from msbwt_jax.utils.profiling import build_roofline, query_roofline, timeit


@pytest.fixture(scope="module")
def decoded():
    reads, lengths = encode_reads(
        [convert_stoi(s) for s in ["CCGTACGTA", "GGTACAGTA", "ACGACGACG"] * 7]
    )
    return build_msbwt(reads, lengths)


def test_index_cache_roundtrip(tmp_path, decoded):
    import jax.numpy as jnp

    index = build_occ_index(jnp.asarray(decoded))
    p = tmp_path / "cache.npz"
    checkpoint.save_index_cache(index, str(p))
    loaded = checkpoint.load_index_cache(str(p))
    assert loaded.n == index.n
    kmers = np.array([convert_stoi("ACG")], dtype=np.uint8)
    assert count_kmers(loaded, kmers).tolist() == count_kmers(index, kmers).tolist()


def test_query_pack_roundtrip(tmp_path, decoded):
    """Full query pack (packed + pair + cache) restores every batched path."""
    import jax.numpy as jnp

    from msbwt_jax.ops.packed_rank import count_kmers_packed, pack_index
    from msbwt_jax.ops.pair_rank import build_pair_index, count_kmers_pair
    from msbwt_jax.ops.rank import build_kmer_cache

    index = build_occ_index(jnp.asarray(decoded))
    packed = pack_index(index)
    pair = build_pair_index(index)
    cache = build_kmer_cache(index.bwt, index.occ, index.starts, index.n, 3)
    p = str(tmp_path / "pack.npz")
    checkpoint.save_query_pack(p, packed=packed, pair=pair, cache=cache,
                               cache_k=3)
    lp, lpair, lcache, ck = checkpoint.load_query_pack(p)
    assert ck == 3
    kmers = np.array([convert_stoi("ACG"), convert_stoi("GTA")], np.uint8)
    want = count_kmers(index, kmers).tolist()
    assert count_kmers_packed(lp, kmers).tolist() == want
    assert count_kmers_pair(lpair, kmers).tolist() == want
    assert count_kmers_pair(lpair, kmers, cache=lcache, cache_k=ck).tolist() \
        == want


def test_query_pack_on_rle_bwt(tmp_path, decoded):
    """RleBWT.save_query_indexes / load_query_indexes round-trip, plus the
    mismatched-BWT guard."""
    from msbwt_jax.models.rle_bwt import RleBWT
    from msbwt_jax.ops.rle import bytes_from_runs, runs_from_symbols

    rle = bytes_from_runs(*runs_from_symbols(decoded))
    a = RleBWT()
    a.load_vector(rle)
    a.enable_pair_index()
    a.enable_kmer_cache(3)
    p = str(tmp_path / "pack.npz")
    a.save_query_indexes(p)

    b = RleBWT()
    b.load_vector(rle)
    b.load_query_indexes(p)
    assert b._pair_index is not None and b._cache_k == 3
    kmers = np.array([convert_stoi("ACG"), convert_stoi("CGT")], np.uint8)
    assert b.count_kmers(kmers).tolist() == a.count_kmers(kmers).tolist()

    other = RleBWT()
    other.load_vector(bytes_from_runs(*runs_from_symbols(
        np.asarray(convert_stoi(naive_bwt(["ACGT", "AAAA"])), np.uint8)
    )))
    with pytest.raises(IOError):
        other.load_query_indexes(p)


def test_query_pack_extensionless_path(tmp_path, decoded):
    """np.savez appends '.npz' to bare string paths; the pack writer must
    honor the exact filename or save->isfile->load never round-trips."""
    import jax.numpy as jnp

    from msbwt_jax.ops.packed_rank import pack_index

    index = build_occ_index(jnp.asarray(decoded))
    p = str(tmp_path / "indexes.pack")  # no .npz extension
    checkpoint.save_query_pack(p, packed=pack_index(index))
    assert (tmp_path / "indexes.pack").is_file()
    lp, _, _, _ = checkpoint.load_query_pack(p)
    assert int(lp.n) == int(index.n)


def test_save_query_indexes_skips_underived_packed(tmp_path, decoded):
    """A pair-only engine must not derive (and host-copy) the packed table
    just to persist its indexes — save what was built."""
    from msbwt_jax.models.rle_bwt import RleBWT
    from msbwt_jax.ops.rle import bytes_from_runs, runs_from_symbols

    rle = bytes_from_runs(*runs_from_symbols(decoded))
    a = RleBWT()
    a.load_vector(rle)
    a.enable_pair_index()
    p = str(tmp_path / "pair_only.npz")
    a.save_query_indexes(p)
    assert a._packed_index is None  # not derived as a side effect
    lp, lpair, _, _ = checkpoint.load_query_pack(p)
    assert lp is None and lpair is not None

    # with no index built at all, the fallback derives packed so the
    # pack is never empty
    b = RleBWT()
    b.load_vector(rle)
    p2 = str(tmp_path / "fresh.npz")
    b.save_query_indexes(p2)
    lp2, _, _, _ = checkpoint.load_query_pack(p2)
    assert lp2 is not None


def test_sharded_checkpoint_roundtrip(tmp_path, decoded):
    d = str(tmp_path / "shards")
    checkpoint.save_sharded(decoded, d, 4)
    m = checkpoint.load_manifest(d)
    assert m["n_shards"] == 4
    assert m["total_size"] == decoded.size
    back = checkpoint.load_sharded(d)
    assert back.tolist() == decoded.tolist()
    # each shard file is itself a valid comp_msbwt.npy
    one = checkpoint.load_shard(d, 2)
    lo, hi = m["boundaries"][2], m["boundaries"][3]
    assert one.tolist() == decoded[lo:hi].tolist()


def test_resume_and_extend_from_checkpoint(tmp_path):
    first = ["ACGT", "TGCA"]
    reads, lengths = encode_reads([convert_stoi(s) for s in first])
    base = build_msbwt(reads, lengths)
    d = str(tmp_path / "ck")
    checkpoint.save_sharded(base, d, 2)
    resumed = checkpoint.load_sharded(d)
    reads2, lengths2 = encode_reads([convert_stoi("GATTACA")])
    out = build_msbwt(reads2, lengths2, base=resumed, base_string_count=2)
    from msbwt_jax.ops.alphabet import convert_itos

    assert convert_itos(out) == naive_bwt(first + ["GATTACA"])


def test_debug_checks_toggle():
    checks.set_debug(True)
    try:
        with pytest.raises(ValueError):
            checks.validate_kmers(np.array([[7]], dtype=np.uint8), None)
        with pytest.raises(ValueError):
            # interior '$'
            checks.validate_reads(
                np.array([[1, 0, 2]], dtype=np.uint8), np.array([3], np.int32)
            )
        # trailing padding zeros are fine
        checks.validate_reads(
            np.array([[1, 2, 0]], dtype=np.uint8), np.array([2], np.int32)
        )
    finally:
        checks.set_debug(False)
    # disabled -> no-op
    checks.validate_kmers(np.array([[7]], dtype=np.uint8), None)


def test_determinism_harness(decoded):
    import jax.numpy as jnp

    index = build_occ_index(jnp.asarray(decoded))
    kmers = np.zeros((16, 3), dtype=np.uint8)
    kmers[:] = convert_stoi("ACG")
    checks.assert_deterministic(lambda: count_kmers(index, kmers))


def test_rooflines_and_timeit():
    r = query_roofline(1_000_000, 21, measured_seconds=0.25, hbm_bw=3.35e12)
    assert 0 < r.fraction_of_light < 1
    b = build_roofline(1_000_000, 100, measured_seconds=1.0, hbm_bw=3.35e12)
    assert b.bytes_touched == 101 * 1_000_000 * 12
    dt = timeit(lambda: np.arange(10), reps=2, warmup=1)
    assert dt >= 0


def test_session_health_smoke():
    """The device-ceiling probe (bf16 matmul + copy) — smoke it at tiny
    sizes on the CPU."""
    from msbwt_jax.utils.profiling import session_health

    h = session_health(mm_n=256, copy_mwords=1)
    assert set(h) == {"matmul_tflops_bf16", "copy_gbps"}
    assert all(v > 0 for v in h.values())


def test_enable_persistent_cache_idempotent(tmp_path, monkeypatch):
    import jax

    from msbwt_jax.utils.jaxcache import enable_persistent_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    try:
        assert enable_persistent_cache() == str(tmp_path / "jc")
        enable_persistent_cache()  # second call must be harmless
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "jc")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert (tmp_path / "jc").is_dir()


@pytest.mark.parametrize("env", ["", "set"])
def test_cache_dir_rule(tmp_path, monkeypatch, env):
    """$JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed
    directory inside the checkout (listed in .gitignore)."""
    import os

    from msbwt_jax.utils import jaxcache

    if env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert jaxcache.cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert jaxcache.cache_dir() == os.path.join(repo, ".jax_cache")
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("kind,ok", [("NVIDIA H100 80GB HBM3", True),
                                     ("cpu", False), ("Tesla V100-SXM2-16GB", False)])
def test_device_peaks_table(kind, ok):
    """The H100 resolves to its data-sheet peaks; any other kind raises."""
    from msbwt_jax.utils.profiling import device_peaks

    if ok:
        p = device_peaks(kind)
        assert p["hbm_bytes_per_s"] == 3.35e12
        assert p["bf16_flops_per_s"] == 989e12
    else:
        with pytest.raises(ValueError, match="no published peaks"):
            device_peaks(kind)


def test_rooflines_need_a_known_device():
    """Without an explicit bandwidth the roofline reads the current
    device's peak — the CPU has none, so it raises instead of guessing."""
    with pytest.raises(ValueError):
        query_roofline(1_000, 21, measured_seconds=1.0)
