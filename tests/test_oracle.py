"""Oracle self-tests (mirrors ref: src/bwt_util.rs:189-275)."""

from msbwt_jax.utils.oracle import naive_bwt, pairwise_bwt_merge


def test_basic():
    assert naive_bwt(["CCGT", "N", "ACG"]) == "GTN$$ACCC$G"


def test_diff_len():
    assert naive_bwt(["A", "AA", "AAA"]) == "AAA$AA$A$"


def test_cycle_breaker():
    # breaks if rotations are not doubled (ref: src/bwt_util.rs:221-236)
    assert naive_bwt(["ACA", "CA"]) == "AACC$A$"


def _check_merge(data):
    truth = naive_bwt(data)
    bwts = [naive_bwt([s]) for s in data]
    current = list(bwts.pop())
    while bwts:
        current = pairwise_bwt_merge(current, list(bwts.pop()))
    assert "".join(current) == truth


def test_merge_paper_example():
    _check_merge(["ACCA", "CAAA"])


def test_merge_diff_sizes():
    _check_merge(["ACCA", "CA"])


def test_merge_high_similarity():
    _check_merge(["A", "AA", "AAA", "AAAA", "AAAAA"])
    _check_merge(["AAAAA", "AAAA", "AAA", "AA", "A"])
