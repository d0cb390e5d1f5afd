"""Partitioned (merge-free) multi-device MSBWT: per-shard counts are
additive over disjoint read partitions, so counting queries need no merge."""

import numpy as np
import jax.numpy as jnp
import pytest

from msbwt_jax.ops.bcr import build_msbwt, encode_reads
from msbwt_jax.ops.rank import build_occ_index, count_kmers
from msbwt_jax.parallel.partitioned import (
    build_partitioned,
    count_kmers_partitioned,
)


def _collection(seed, n=60):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 6, rng.integers(4, 35)).astype(np.uint8)
            for _ in range(n)]


def test_partitioned_counts_match_global():
    reads_l = _collection(3)
    reads, lens = encode_reads(reads_l)
    dec = build_msbwt(reads, lens)
    idx_global = build_occ_index(jnp.asarray(dec))
    pidx = build_partitioned(reads, lens)

    rng = np.random.default_rng(4)
    B, K = 64, 6
    klens = rng.integers(1, K + 1, B).astype(np.int32)
    kmers = np.zeros((B, K), np.uint8)
    for i, l in enumerate(klens):
        kmers[i, K - l:] = rng.integers(1, 6, l)
    # right-aligned padding is 0 ('$'); replace with 1 so the $-free check
    # passes — padded columns are masked by lengths anyway
    kmers[kmers == 0] = 1
    want = count_kmers(idx_global, kmers, klens)
    got = count_kmers_partitioned(pidx, kmers, klens)
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_partitioned_rejects_terminator_queries():
    reads, lens = encode_reads(_collection(5, n=10))
    pidx = build_partitioned(reads, lens)
    with pytest.raises(AssertionError):
        count_kmers_partitioned(pidx, np.zeros((1, 3), np.uint8))


def test_partitioned_wide_counts():
    """int64 count combine (for collections past 2^31 total symbols) must
    agree with the int32 path on small data."""
    reads_l = _collection(7, n=30)
    reads, lens = encode_reads(reads_l)
    pidx = build_partitioned(reads, lens)
    kmers = np.stack([reads[i, 1:5] for i in range(12)]).astype(np.uint8)
    kmers[kmers == 0] = 1
    a = count_kmers_partitioned(pidx, kmers, wide=False)
    b = count_kmers_partitioned(pidx, kmers, wide=True)
    assert np.asarray(b).dtype == np.int64
    assert np.array_equal(np.asarray(a), np.asarray(b))
