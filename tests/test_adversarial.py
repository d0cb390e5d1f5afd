"""Adversarial construction cases distilled from earlier fuzz campaigns:
heavy duplication (dense insertion runs, terminator ties), periodic reads
(cyclic tie-breaking / Fine-Wilf bound in the terminator search), prefix
families, and chained extends. All checked against the naive oracle or the
independently-validated one-shot build."""

import numpy as np

from msbwt_jax.ops.alphabet import convert_itos
from msbwt_jax.ops.bcr import build_msbwt, encode_reads
from msbwt_jax.utils.oracle import naive_bwt


def _oracle_check(reads_l):
    reads, lens = encode_reads(reads_l)
    got = build_msbwt(reads, lens)
    assert convert_itos(got) == naive_bwt([convert_itos(r) for r in reads_l])


def test_identical_reads():
    _oracle_check([np.full(12, 3, np.uint8)] * 40)


def test_identical_plus_one():
    _oracle_check([np.full(10, 2, np.uint8)] * 30 + [np.full(10, 5, np.uint8)])


def test_length_one_reads():
    rng = np.random.default_rng(1)
    _oracle_check([np.array([rng.integers(1, 6)], np.uint8) for _ in range(25)])


def test_periodic_and_rotated():
    per = np.tile([1, 2], 8).astype(np.uint8)
    rot = np.tile([2, 1], 8).astype(np.uint8)
    _oracle_check([per] * 8 + [rot] * 8)


def test_nested_periods():
    _oracle_check([np.tile([1], 9).astype(np.uint8)] * 8
                  + [np.tile([1, 1, 2], 3).astype(np.uint8)] * 8)


def test_prefix_family():
    rng = np.random.default_rng(2)
    base = rng.integers(1, 6, 24).astype(np.uint8)
    _oracle_check([base[:k] for k in range(1, 24, 3)] * 2)


def test_extend_duplicate_spanning_base_and_batch():
    rng = np.random.default_rng(3)
    dup = np.tile([1, 2, 3], 4).astype(np.uint8)
    base_l = [dup] * 6 + [rng.integers(1, 6, 10).astype(np.uint8) for _ in range(4)]
    new_l = [dup] * 5
    base_r, base_len = encode_reads(base_l)
    new_r, new_len = encode_reads(new_l)
    base = build_msbwt(base_r, base_len)
    got = build_msbwt(new_r, new_len, base=base, base_string_count=len(base_l))
    all_r, all_len = encode_reads(base_l + new_l)
    assert np.array_equal(got, build_msbwt(all_r, all_len))


def test_extend_batch_longer_than_base():
    rng = np.random.default_rng(4)
    base_l = [rng.integers(1, 6, 5).astype(np.uint8) for _ in range(8)]
    new_l = [rng.integers(1, 6, 40).astype(np.uint8) for _ in range(3)]
    base_r, base_len = encode_reads(base_l)
    new_r, new_len = encode_reads(new_l)
    base = build_msbwt(base_r, base_len)
    got = build_msbwt(new_r, new_len, base=base, base_string_count=len(base_l))
    all_r, all_len = encode_reads(base_l + new_l)
    assert np.array_equal(got, build_msbwt(all_r, all_len))


def test_chained_extends():
    rng = np.random.default_rng(5)
    batches = [[rng.integers(1, 6, rng.integers(2, 14)).astype(np.uint8)
                for _ in range(int(rng.integers(2, 8)))] for _ in range(3)]
    cur, cnt = None, 0
    for b in batches:
        r, ln = encode_reads(b)
        cur = build_msbwt(r, ln, base=cur, base_string_count=cnt)
        cnt += len(b)
    allb = [x for b in batches for x in b]
    r, ln = encode_reads(allb)
    assert np.array_equal(cur, build_msbwt(r, ln))
