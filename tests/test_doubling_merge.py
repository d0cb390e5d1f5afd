"""Distributed prefix-doubling merge vs oracle / H-M / single-device
doubling on the 8-virtual-device CPU mesh."""

import numpy as np
import pytest

from msbwt_jax.ops.alphabet import convert_itos, convert_stoi
from msbwt_jax.ops.bcr import build_msbwt, encode_reads
from msbwt_jax.ops.merge import multiway_bwt_merge
from msbwt_jax.parallel.doubling_merge import sharded_doubling_merge
from msbwt_jax.utils.oracle import naive_bwt


def _bwt_of(strings):
    reads, lengths = encode_reads([convert_stoi(s) for s in strings])
    return build_msbwt(reads, lengths)


def test_sharded_doubling_vs_oracle_fuzz(rng):
    alpha = list("ACGNT")
    for _ in range(6):
        ns = int(rng.integers(2, 9))
        groups = [
            ["".join(rng.choice(alpha, size=int(rng.integers(1, 14))))
             for _ in range(int(rng.integers(1, 5)))]
            for _ in range(ns)
        ]
        got = sharded_doubling_merge([_bwt_of(g) for g in groups])
        assert convert_itos(got) == naive_bwt([s for g in groups for s in g])


def test_sharded_doubling_tie_stress():
    """Identical strings across every source: ranks tie forever and the
    fixpoint must land on source-major order (== H-M's stable order)."""
    groups = [["AAAA", "AAAA"], ["AAAA"], ["AAAA", "AAAA", "AAAA"]]
    parts = [_bwt_of(g) for g in groups]
    got, srcs = sharded_doubling_merge(parts, return_sources=True)
    ref, srcs_ref = multiway_bwt_merge(parts, return_sources=True)
    assert got.tolist() == ref.tolist()
    assert srcs.tolist() == srcs_ref.tolist()
    assert convert_itos(got) == naive_bwt([s for g in groups for s in g])


def test_sharded_doubling_matches_hm_and_sources(rng):
    from msbwt_jax.parallel.sharded_merge import sharded_hm_merge

    alpha = list("ACGT")
    groups = [
        ["".join(rng.choice(alpha, size=20)) for _ in range(3)]
        for _ in range(4)
    ]
    parts = [_bwt_of(g) for g in groups]
    got, srcs = sharded_doubling_merge(parts, return_sources=True)
    hm = sharded_hm_merge(parts)
    assert got.tolist() == hm.tolist()
    ref, srcs_ref = multiway_bwt_merge(parts, return_sources=True)
    assert srcs.tolist() == srcs_ref.tolist()


def test_sharded_doubling_wide_mode(rng):
    alpha = list("ACGNT")
    groups = [["".join(rng.choice(alpha, size=11)) for _ in range(3)]
              for _ in range(3)]
    parts = [_bwt_of(g) for g in groups]
    narrow = sharded_doubling_merge(parts)
    wide = sharded_doubling_merge(parts, force_wide=True)
    assert narrow.tolist() == wide.tolist()
    assert convert_itos(narrow) == naive_bwt([s for g in groups for s in g])


def test_sharded_doubling_more_sources_than_devices(rng):
    """ns > D: sources are element-sharded, not device-mapped, so any
    source count works on any mesh."""
    alpha = list("ACGT")
    groups = [["".join(rng.choice(alpha, size=int(rng.integers(2, 9))))]
              for _ in range(13)]
    got = sharded_doubling_merge([_bwt_of(g) for g in groups])
    assert convert_itos(got) == naive_bwt([s for g in groups for s in g])


def test_sharded_doubling_long_reads(rng):
    """Long rotation periods (the case H-M round counts blow up on)."""
    alpha = list("ACGT")
    groups = [["".join(rng.choice(alpha, size=300))] for _ in range(3)]
    got = sharded_doubling_merge([_bwt_of(g) for g in groups])
    assert convert_itos(got) == naive_bwt([s for g in groups for s in g])


def test_sharded_doubling_empty_and_single():
    assert sharded_doubling_merge([]).size == 0
    one = _bwt_of(["GATTACA"])
    got = sharded_doubling_merge([np.zeros(0, np.uint8), one])
    assert got.tolist() == one.tolist()
