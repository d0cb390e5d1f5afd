"""Static engine tests (mirrors ref: src/rle_bwt.rs:470-711)."""

import numpy as np
import pytest

from msbwt_jax.models.core import BWTRange
from msbwt_jax.models.rle_bwt import RleBWT, build_sampled_fm_index
from msbwt_jax.ops.alphabet import VC_LEN, convert_stoi
from msbwt_jax.ops.rle import convert_to_vec
from msbwt_jax.utils.npy import save_bwt_bytes
from msbwt_jax.utils.oracle import naive_bwt


def test_load_from_npy(tmp_path):
    # ref: src/rle_bwt.rs:478-503
    bwt_stream = naive_bwt(["CCGT", "N", "ACG"])
    compressed = convert_to_vec(bwt_stream)
    path = tmp_path / "t.npy"
    save_bwt_bytes(compressed, str(path))
    bwt = RleBWT()
    bwt.load_numpy_file(str(path))
    assert [bwt.get_symbol_count(i) for i in range(6)] == [3, 1, 3, 2, 1, 1]
    assert bwt.get_total_size() == 11


# pinned FM-index tables from ref tests src/rle_bwt.rs:536-599
_PINNED = {
    1: (
        [0, 2, 3, 5, 5, 7, 8],
        [
            [0, 0, 0, 2, 2, 3, 3],
            [0, 0, 0, 1, 1, 1, 1],
            [0, 0, 0, 0, 0, 3, 3],
            [0, 1, 1, 1, 1, 1, 2],
            [0, 0, 1, 1, 1, 1, 1],
            [0, 1, 1, 1, 1, 1, 1],
        ],
    ),
    2: (
        [0, 3, 5, 8],
        [
            [0, 0, 2, 3],
            [0, 0, 1, 1],
            [0, 0, 0, 3],
            [0, 1, 1, 2],
            [0, 1, 1, 1],
            [0, 1, 1, 1],
        ],
    ),
    3: (
        [0, 5, 8],
        [
            [0, 2, 3],
            [0, 1, 1],
            [0, 0, 3],
            [0, 1, 2],
            [0, 1, 1],
            [0, 1, 1],
        ],
    ),
    4: (
        [0, 8],
        [
            [0, 3],
            [0, 1],
            [0, 3],
            [0, 2],
            [0, 1],
            [0, 1],
        ],
    ),
}


def test_fmindex_pinned_tables():
    bwt_stream = naive_bwt(["CCGT", "N", "ACG"])
    assert bwt_stream == "GTN$$ACCC$G"
    compressed = convert_to_vec(bwt_stream)
    assert compressed.size == 8  # [G, T, N, 2$, A, 3C, $, G]
    for bin_power, (exp_ref, exp_fm) in _PINNED.items():
        ref_index, fm_index = build_sampled_fm_index(compressed, bin_power)
        expected_len = int(np.ceil(len(bwt_stream) / (1 << bin_power))) + 1
        assert ref_index.size == expected_len
        assert ref_index.tolist() == exp_ref, f"bin_power={bin_power}"
        assert fm_index.tolist() == exp_fm, f"bin_power={bin_power}"


def test_constrain_range_exhaustive():
    # ref: src/rle_bwt.rs:603-675 — every symbol x every split point
    bwt_stream = naive_bwt(["CCGT", "N", "ACG"])
    bwt_int = convert_stoi(bwt_stream)
    compressed = convert_to_vec(bwt_stream)
    n = len(bwt_stream)
    for bin_power in range(1, 5):
        bwt = RleBWT.with_bin_power(bin_power)
        bwt.load_vector(compressed)

        for sym in range(VC_LEN):
            rng = bwt.constrain_range(sym, BWTRange(0, n))
            assert rng == BWTRange(int(bwt.start_index[sym]), int(bwt.end_index[sym]))

        for sym in range(VC_LEN):
            sym_count = 0
            for ind in range(n + 1):
                rng = bwt.constrain_range(sym, BWTRange(0, ind))
                assert rng == BWTRange(
                    int(bwt.start_index[sym]), int(bwt.start_index[sym]) + sym_count
                )
                rng = bwt.constrain_range(sym, BWTRange(ind, n))
                assert rng == BWTRange(
                    int(bwt.start_index[sym]) + sym_count, int(bwt.end_index[sym])
                )
                if ind < n and bwt_int[ind] == sym:
                    sym_count += 1


def test_count_kmer():
    # ref: src/rle_bwt.rs:677-710
    data = ["CCGTACGTA", "GGTACAGTA", "ACGACGACG"]
    compressed = convert_to_vec(naive_bwt(data))
    for bin_power in range(1, 5):
        bwt = RleBWT.with_bin_power(bin_power)
        bwt.load_vector(compressed)
        for c in range(VC_LEN):
            assert bwt.get_symbol_count(c) == bwt.count_kmer([c])
        for seq in data:
            assert bwt.count_kmer(convert_stoi(seq)) == 1
        assert bwt.count_kmer(convert_stoi("ACG")) == 4
        assert bwt.count_kmer(convert_stoi("CC")) == 1
        assert bwt.count_kmer(convert_stoi("TAC")) == 2


def test_count_kmers_batched_device():
    data = ["CCGTACGTA", "GGTACAGTA", "ACGACGACG"]
    bwt = RleBWT()
    bwt.load_vector(convert_to_vec(naive_bwt(data)))
    queries = ["ACG", "CC", "TAC", "CCGTACGTA", "T", "NNN"]
    K = max(len(q) for q in queries)
    kmers = np.zeros((len(queries), K), dtype=np.uint8)
    lengths = np.array([len(q) for q in queries], dtype=np.int32)
    for i, q in enumerate(queries):
        kmers[i, K - len(q):] = convert_stoi(q)
    out = bwt.count_kmers(kmers, lengths)
    assert out.tolist() == [4, 1, 2, 1, 4, 0]


def test_count_kmer_rejects_bad_symbols():
    bwt = RleBWT()
    bwt.load_vector(convert_to_vec("ACGT$"))
    with pytest.raises(AssertionError):
        bwt.count_kmer([6])


def test_golden_two_string_queries():
    bwt = RleBWT()
    from tests._data import GOLDEN_NPY
    bwt.load_numpy_file(GOLDEN_NPY)
    assert bwt.count_kmer(convert_stoi("ACGT")) == 1
    assert bwt.count_kmer(convert_stoi("TGCA")) == 1
    assert bwt.count_kmer(convert_stoi("$")) == 2
    assert bwt.get_symbol_count(0) == 2
    assert bwt.get_total_size() == 10


def test_kmer_profile():
    """Window counts of every read position (the error-correction primitive)."""
    from msbwt_jax.ops.bcr import build_msbwt, encode_reads
    from msbwt_jax.ops.rle import bytes_from_runs, runs_from_symbols

    rng = np.random.default_rng(8)
    reads_l = [rng.integers(1, 6, 20).astype(np.uint8) for _ in range(30)]
    reads, lens = encode_reads(reads_l)
    decoded = build_msbwt(reads, lens)
    bwt = RleBWT()
    bwt.load_vector(bytes_from_runs(*runs_from_symbols(decoded)))
    k = 5
    prof = bwt.kmer_profile(reads[:4], k)
    assert prof.shape == (4, 20 - k + 1)
    for i in range(4):
        for j in range(20 - k + 1):
            assert prof[i, j] == bwt.count_kmer(reads[i, j : j + k])
    assert (prof >= 1).all()  # every window occurs at least in its own read


def test_count_kmers_bidirectional():
    """fw + rc counting (the double-stranded application convention),
    verified against explicit two-query sums incl. ragged lengths and
    palindromes."""
    from msbwt_jax.models.rle_bwt import RleBWT
    from msbwt_jax.ops.alphabet import (
        convert_stoi, reverse_complement_i,
    )
    from msbwt_jax.ops.rle import bytes_from_runs, runs_from_symbols
    from msbwt_jax.utils.oracle import naive_bwt

    rng = np.random.default_rng(13)
    data = ["".join(rng.choice(list("ACGNT"), size=18)) for _ in range(40)]
    dec = np.asarray(convert_stoi(naive_bwt(data)), np.uint8)
    bwt = RleBWT()
    bwt.load_vector(bytes_from_runs(*runs_from_symbols(dec)))
    B, K = 60, 7
    kmers = rng.integers(0, 6, size=(B, K)).astype(np.uint8)
    lens = rng.integers(1, K + 1, B).astype(np.int32)
    for i in range(B):
        kmers[i, : K - lens[i]] = 0
    kmers[0] = convert_stoi("GCATGC")[None, :][0, :6].tolist() + [0]  # near-palindrome content
    got = bwt.count_kmers_bidirectional(kmers, lens)
    for i in range(B):
        fw = bwt.count_kmer(kmers[i, K - lens[i]:])
        rc = bwt.count_kmer(reverse_complement_i(kmers[i, K - lens[i]:]))
        assert got[i] == fw + rc, i


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _runny_engine(n_runs: int, run_len: int) -> RleBWT:
    """An engine whose metadata says n_runs runs over n_runs*run_len
    symbols (the tier policy reads only sizes)."""
    b = RleBWT()
    b.total_size = n_runs * run_len
    b.n_runs = n_runs
    return b


@pytest.mark.parametrize(
    "stats,env,want_budget,want_run_tier",
    [
        # 80 GB card: 0.75 x bytes_limit; 9 B/pos x 10G symbols exceeds it
        ({"bytes_limit": 80_000_000_000}, None, 60e9, True),
        # small limit, small index: decoded tiers fit
        ({"bytes_limit": 1_000_000_000}, None, 0.75e9, False),
        # a device that reports no limit: no budget is invented
        (None, None, None, False),
        ({}, None, None, False),
        # explicit override wins over the device
        ({"bytes_limit": 80_000_000_000}, "2", 2e9, True),
    ],
)
def test_device_budget_policy(monkeypatch, stats, env, want_budget,
                              want_run_tier):
    import jax

    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice(stats)])
    monkeypatch.delenv("MSBWT_RUN_TIER", raising=False)
    if env is None:
        monkeypatch.delenv("MSBWT_DEVICE_BUDGET_GB", raising=False)
    else:
        monkeypatch.setenv("MSBWT_DEVICE_BUDGET_GB", env)
    small = stats and stats.get("bytes_limit") == 1_000_000_000
    b = _runny_engine(n_runs=1_000_000 if small else 250_000_000, run_len=40)
    assert b.device_budget_bytes() == want_budget
    assert b._auto_run_tier() is want_run_tier
