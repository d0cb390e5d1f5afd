"""Device Holt–McMillan merge vs the host oracle and naive BWT."""

import numpy as np

from msbwt_jax.ops.alphabet import convert_itos, convert_stoi
from msbwt_jax.ops.bcr import build_msbwt, encode_reads
from msbwt_jax.ops.merge import kway_merge, pairwise_bwt_merge
from msbwt_jax.utils.oracle import naive_bwt


def _bwt_of(strings):
    reads, lengths = encode_reads([convert_stoi(s) for s in strings])
    return build_msbwt(reads, lengths)


def test_paper_example():
    a, b = ["ACCA"], ["CAAA"]
    got = pairwise_bwt_merge(_bwt_of(a), _bwt_of(b))
    assert convert_itos(got) == naive_bwt(a + b)


def test_diff_sizes_and_order():
    a, b = ["ACCA"], ["CA"]
    assert convert_itos(pairwise_bwt_merge(_bwt_of(a), _bwt_of(b))) == naive_bwt(a + b)
    assert convert_itos(pairwise_bwt_merge(_bwt_of(b), _bwt_of(a))) == naive_bwt(a + b)


def test_high_similarity():
    data = ["A", "AA", "AAA", "AAAA", "AAAAA"]
    cur = _bwt_of([data[0]])
    for s in data[1:]:
        cur = pairwise_bwt_merge(cur, _bwt_of([s]))
    assert convert_itos(cur) == naive_bwt(data)


def test_multi_string_halves():
    left = ["CCGTACGTA", "GGTACAGTA"]
    right = ["ACGACGACG", "TTTT", "N"]
    got = pairwise_bwt_merge(_bwt_of(left), _bwt_of(right))
    assert convert_itos(got) == naive_bwt(left + right)


def test_kway():
    groups = [["ACG", "T"], ["CCGT"], ["N", "NA"], ["GATTACA"]]
    got = kway_merge([_bwt_of(g) for g in groups])
    assert convert_itos(got) == naive_bwt([s for g in groups for s in g])


def test_empty_inputs():
    assert pairwise_bwt_merge(np.zeros(0, np.uint8), _bwt_of(["A"])).tolist() == [1, 0]
    assert kway_merge([]).size == 0


def test_random_merges(rng):
    alpha = list("ACGNT")
    for _ in range(10):
        left = ["".join(rng.choice(alpha, size=int(rng.integers(1, 12))))
                for _ in range(int(rng.integers(1, 8)))]
        right = ["".join(rng.choice(alpha, size=int(rng.integers(1, 12))))
                 for _ in range(int(rng.integers(1, 8)))]
        got = pairwise_bwt_merge(_bwt_of(left), _bwt_of(right))
        assert convert_itos(got) == naive_bwt(left + right)


def test_pairwise_merge_wide_mode():
    """int64 ("wide") positions — the >2^31-symbol path — must agree with
    the int32 path on small data."""
    from msbwt_jax.ops.merge import pairwise_bwt_merge

    rng = np.random.default_rng(55)
    a = naive_bwt(["".join(rng.choice(list("ACGT"), size=15)) for _ in range(10)])
    b = naive_bwt(["".join(rng.choice(list("ACGT"), size=9)) for _ in range(14)])
    ai = np.asarray(convert_stoi(a), np.uint8)
    bi = np.asarray(convert_stoi(b), np.uint8)
    assert np.array_equal(
        pairwise_bwt_merge(ai, bi, force_wide=True),
        pairwise_bwt_merge(ai, bi),
    )


def test_doubling_multiway_vs_oracle(rng):
    """One-shot doubling merge == naive oracle over random D-way splits,
    including duplicate strings across and within sources (tie order)."""
    from msbwt_jax.ops.merge import multiway_bwt_merge

    alpha = list("ACGNT")
    for _ in range(8):
        d = int(rng.integers(2, 7))
        groups = []
        for _ in range(d):
            strs = ["".join(rng.choice(alpha, size=int(rng.integers(1, 12))))
                    for _ in range(int(rng.integers(1, 6)))]
            groups.append(strs)
        # inject duplicates: same string in two sources and twice in one
        groups[0].append("ACGT")
        groups[-1].append("ACGT")
        groups[0].append("ACGT")
        got = multiway_bwt_merge([_bwt_of(g) for g in groups])
        assert convert_itos(got) == naive_bwt([s for g in groups for s in g])


def test_doubling_equals_tree_and_sources():
    """Doubling == pairwise tree byte-for-byte; source ids reconstruct the
    pairwise interleave."""
    import os

    from msbwt_jax.ops.merge import merge_interleave, multiway_bwt_merge

    groups = [["ACG", "T", "ACG"], ["CCGT", "ACG"], ["N", "NA"], ["GATTACA"]]
    parts = [_bwt_of(g) for g in groups]
    os.environ["MSBWT_MERGE"] = "tree"
    try:
        tree = kway_merge(parts)
    finally:
        os.environ.pop("MSBWT_MERGE", None)
    got, srcs = multiway_bwt_merge(parts, return_sources=True)
    assert got.tolist() == tree.tolist()
    # pairwise: source ids vs the H-M interleave vector
    a, b = parts[0], parts[1]
    inter = merge_interleave(a, b)
    _, src2 = multiway_bwt_merge([a, b], return_sources=True)
    assert (src2 == 0).tolist() == inter.tolist()


def test_doubling_wide_mode():
    """Forced-int64 doubling merge == int32 doubling merge."""
    from msbwt_jax.ops.merge import multiway_bwt_merge

    rng = np.random.default_rng(77)
    alpha = list("ACGNT")
    groups = [["".join(rng.choice(alpha, size=9)) for _ in range(4)]
              for _ in range(3)]
    parts = [_bwt_of(g) for g in groups]
    narrow = multiway_bwt_merge(parts)
    wide = multiway_bwt_merge(parts, force_wide=True)
    assert narrow.tolist() == wide.tolist()
    assert convert_itos(narrow) == naive_bwt([s for g in groups for s in g])


def test_doubling_single_and_empty_sources():
    from msbwt_jax.ops.merge import multiway_bwt_merge

    one = _bwt_of(["GATTACA"])
    assert multiway_bwt_merge([one]).tolist() == one.tolist()
    got = multiway_bwt_merge([np.zeros(0, np.uint8), one])
    assert got.tolist() == one.tolist()
    assert multiway_bwt_merge([]).size == 0
