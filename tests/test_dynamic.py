"""Dynamic engine tests (mirrors ref: src/dynamic_bwt.rs:475-818)."""

import numpy as np

from msbwt_jax.models.core import BWTRange
from msbwt_jax.models.dynamic import DynamicBWT, create_from_fastx
from msbwt_jax.ops.alphabet import VC_LEN, convert_stoi
from msbwt_jax.ops.rle import convert_to_vec
from msbwt_jax.utils.npy import save_bwt_bytes
from msbwt_jax.utils.oracle import naive_bwt


def test_init_empty():
    assert DynamicBWT().to_vec().tolist() == []


def test_single_string_unsorted():
    b = DynamicBWT()
    b.insert_string("ACGNT", False)
    assert b.to_vec().tolist() == [5, 0, 1, 2, 3, 4]


def test_multi_string_sorted():
    data = ["ACG", "N", "CCGT", "N", "ACG", "ACG", "CCGT", "N"]
    b = DynamicBWT()
    for s in data:
        b.insert_string(s, True)
    assert b.to_vec().tolist() == convert_stoi(naive_bwt(data)).tolist()


def test_mixed_flags():
    # sorted batch, then chronological insert, then sorted again — grouped
    # materialization must honor arrival order between groups
    b = DynamicBWT()
    b.insert_string("ACG", True)
    b.insert_string("CCGT", True)
    b.insert_string("N", False)  # chronological: terminator rank = 2
    got = b.to_vec()
    # sequential model: {ACG, CCGT} sorted == naive; N appended at $-rank 2;
    # with these inputs N's terminator also sorts last lexicographically
    assert got.tolist() == convert_stoi(naive_bwt(["ACG", "CCGT", "N"])).tolist()


def test_load_vector_and_counts():
    compressed = convert_to_vec(naive_bwt(["CCGT", "N", "ACG"]))
    b = DynamicBWT()
    b.load_vector(compressed)
    assert [b.get_symbol_count(i) for i in range(6)] == [3, 1, 3, 2, 1, 1]
    assert b.get_total_size() == 11
    assert b.string_count == 3


def test_load_npy(tmp_path):
    compressed = convert_to_vec(naive_bwt(["CCGT", "N", "ACG"]))
    p = tmp_path / "t.npy"
    save_bwt_bytes(compressed, str(p))
    b = DynamicBWT()
    b.load_numpy_file(str(p))
    assert [b.get_symbol_count(i) for i in range(6)] == [3, 1, 3, 2, 1, 1]


def test_constrain_range_exhaustive():
    # ref: src/dynamic_bwt.rs:628-699
    bwt_stream = naive_bwt(["CCGT", "N", "ACG"])
    bwt_int = convert_stoi(bwt_stream)
    b = DynamicBWT()
    b.load_vector(convert_to_vec(bwt_stream))
    n = len(bwt_stream)
    starts = np.cumsum([0] + [b.get_symbol_count(i) for i in range(5)])
    for sym in range(VC_LEN):
        sym_count = 0
        for ind in range(n + 1):
            rng = b.constrain_range(sym, BWTRange(0, ind))
            assert (rng.l, rng.h) == (starts[sym], starts[sym] + sym_count)
            rng = b.constrain_range(sym, BWTRange(ind, n))
            assert (rng.l, rng.h) == (
                starts[sym] + sym_count,
                starts[sym] + b.get_symbol_count(sym),
            )
            if ind < n and bwt_int[ind] == sym:
                sym_count += 1


def test_count_kmer():
    data = ["CCGTACGTA", "GGTACAGTA", "ACGACGACG"]
    b = DynamicBWT()
    b.load_vector(convert_to_vec(naive_bwt(data)))
    for c in range(VC_LEN):
        assert b.get_symbol_count(c) == b.count_kmer([c])
    for seq in data:
        assert b.count_kmer(convert_stoi(seq)) == 1
    assert b.count_kmer(convert_stoi("ACG")) == 4
    assert b.count_kmer(convert_stoi("CC")) == 1
    assert b.count_kmer(convert_stoi("TAC")) == 2


def test_load_and_add():
    # ref: src/dynamic_bwt.rs:734-773
    data = ["CCGTACGTA", "GGTACAGTA", "ACGACGACG"]
    b = DynamicBWT()
    b.load_vector(convert_to_vec(naive_bwt(data)))
    b.insert_string("AAGTCATAT", True)
    data.append("AAGTCATAT")
    for c in range(VC_LEN):
        assert b.get_symbol_count(c) == b.count_kmer([c])
    for seq in data:
        assert b.count_kmer(convert_stoi(seq)) == 1
    assert b.count_kmer(convert_stoi("ACG")) == 4
    assert b.count_kmer(convert_stoi("CC")) == 1
    assert b.count_kmer(convert_stoi("TAC")) == 2
    assert b.count_kmer(convert_stoi("AA")) == 1
    assert b.count_kmer(convert_stoi("GT")) == 5
    # whole thing must equal a fresh naive rebuild
    assert b.to_vec().tolist() == convert_stoi(naive_bwt(data)).tolist()


def test_create_from_fastx_two_string():
    # ref: src/dynamic_bwt.rs:776-794
    truth = DynamicBWT()
    from tests._data import GOLDEN_FA, GOLDEN_NPY
    truth.load_numpy_file(GOLDEN_NPY)
    bwt = create_from_fastx([GOLDEN_FA], True)
    assert truth.to_vec().tolist() == bwt.to_vec().tolist()
    assert list(truth.iter()) == list(bwt.iter())
    assert truth.count_kmer(convert_stoi("$")) == 2
    assert truth.count_kmer(convert_stoi("ACGT")) == 1
    assert truth.count_kmer(convert_stoi("TGCA")) == 1


def test_create_from_fastx_empty_list():
    bwt = create_from_fastx([], True)
    assert bwt.to_vec().tolist() == []


def test_run_iter():
    # ref: src/dynamic_bwt.rs:796-817
    b = DynamicBWT()
    assert list(b.run_iter()) == []
    b.insert_string("AAAA", True)
    assert list(b.run_iter()) == [(1, 4), (0, 1)]
    b.insert_string("ACCC", True)
    # ACAAA$$CCA
    assert list(b.run_iter()) == [(1, 1), (2, 1), (1, 3), (0, 2), (2, 2), (1, 1)]


def test_insert_string_doctest_example():
    # ref: src/dynamic_bwt.rs:417-427 run_iter doctest
    b = DynamicBWT()
    b.insert_string("ACCC", True)
    assert list(b.run_iter()) == [(2, 1), (0, 1), (2, 2), (1, 1)]


def test_telemetry_analogues():
    b = DynamicBWT()
    assert b.get_height() == 0
    b.insert_string("ACCC", True)
    assert b.get_height() == 2
    assert b.get_node_count() == 4  # C $ CC A -> 4 runs


def test_from_decoded_then_extend():
    """Regression for the --distributed CLI construction: wrapping a decoded
    BWT must leave _max_read_len unknown so a later insert recovers the true
    rotation bound by LF walk (a stale 0 computed wrong terminator ranks)."""
    data = ["CCGTACGTA", "GGTACAGTA", "ACGACGACG"]
    decoded = convert_stoi(naive_bwt(data))
    b = DynamicBWT.from_decoded(decoded)
    assert b.to_vec().tolist() == decoded.tolist()
    b.insert_string("AAGTCATAT", True)
    data.append("AAGTCATAT")
    assert b.to_vec().tolist() == convert_stoi(naive_bwt(data)).tolist()


def test_dynamic_kmer_cache_parity():
    """DynamicBWT.enable_kmer_cache must equal the uncached path and the
    RleBWT cache, and must survive (lazily rebuild across) a mutation."""
    import numpy as np

    from msbwt_jax.models.rle_bwt import RleBWT

    rng = np.random.default_rng(7)
    data = ["".join(rng.choice(list("ACGT"), size=20)) for _ in range(40)]
    b = DynamicBWT()
    b.insert_strings(data, True)
    kmers = np.stack([convert_stoi(s[:8]) for s in data[:25]])
    plain = b.count_kmers(kmers)
    b.enable_kmer_cache(cache_k=4)
    cached = b.count_kmers(kmers)
    assert plain.tolist() == cached.tolist()

    from msbwt_jax.ops.rle import bytes_from_runs, runs_from_symbols

    r = RleBWT()
    r.load_vector(bytes_from_runs(*runs_from_symbols(b.to_vec())))
    r.enable_kmer_cache(cache_k=4)
    assert r.count_kmers(kmers).tolist() == cached.tolist()

    # mutate: the cache must be rebuilt for the NEW index, not served stale
    b.insert_string("TTTTGGGGCCCCAAAATTTT", True)
    data.append("TTTTGGGGCCCCAAAATTTT")
    after = b.count_kmers(kmers)
    fresh = DynamicBWT()
    fresh.insert_strings(data, True)
    assert after.tolist() == fresh.count_kmers(kmers).tolist()


def test_materialize_fused_pallas_path(monkeypatch):
    """The fused-engine materialize path (build_msbwt_with_index,
    device-resident base + indexes) must behave identically to the XLA
    path."""
    from msbwt_jax.ops import bcr

    monkeypatch.setattr(bcr, "default_engine", lambda: "fused")
    data = ["CCGTACGTA", "GGTACAGTA", "ACGACGACG"]
    b = DynamicBWT()
    b.insert_strings(data, True)
    assert b.to_vec().tolist() == convert_stoi(naive_bwt(data)).tolist()
    text = "".join(data)
    want_counts = [3] + [text.count(c) for c in "ACGNT"]
    assert b.get_symbol_counts().tolist() == want_counts
    kmers = np.stack([convert_stoi(s[:4]) for s in data])
    counts = b.count_kmers(kmers)
    assert all(c >= 1 for c in counts.tolist())
    # extend after a fused build (device-resident base)
    b.insert_string("AAGTCATAT", True)
    data.append("AAGTCATAT")
    assert b.to_vec().tolist() == convert_stoi(naive_bwt(data)).tolist()
    assert b.string_count == 4


def test_count_kmers_approx_bruteforce(rng):
    """Hamming<=1 counts equal a brute-force window scan over the reads."""
    from msbwt_jax.models.dynamic import DynamicBWT
    from msbwt_jax.ops.alphabet import convert_itos

    reads_l = [rng.integers(1, 6, int(rng.integers(5, 20))).astype(np.uint8)
               for _ in range(25)]
    bwt = DynamicBWT()
    bwt.insert_strings([convert_itos(r) for r in reads_l], sorted=True)
    K = 4
    kmers = np.stack([rng.integers(1, 6, K).astype(np.uint8)
                      for _ in range(6)])
    got = bwt.count_kmers_approx(kmers, max_mismatch=1)
    for qi in range(6):
        want = 0
        for r in reads_l:
            for off in range(len(r) - K + 1):
                if (r[off : off + K] != kmers[qi]).sum() <= 1:
                    want += 1
        assert got[qi] == want, qi
    # distance 0 degenerates to exact counts
    assert np.array_equal(
        bwt.count_kmers_approx(kmers, max_mismatch=0),
        np.asarray(bwt.count_kmers(kmers), dtype=np.int64),
    )
