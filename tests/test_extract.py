"""Read recovery: the BWT losslessly stores the collection; extraction by
LF-walk must return the original reads (in lexicographic order for sorted
builds)."""

import numpy as np
import jax.numpy as jnp
import pytest

from msbwt_jax.ops.bcr import build_msbwt, encode_reads, sort_reads
from msbwt_jax.ops.extract import extract_reads
from msbwt_jax.ops.rank import build_occ_index


def test_extract_all_reads():
    rng = np.random.default_rng(21)
    reads_l = [rng.integers(1, 6, rng.integers(1, 30)).astype(np.uint8)
               for _ in range(40)]
    reads, lens = encode_reads(reads_l)
    dec = build_msbwt(reads, lens)
    index = build_occ_index(jnp.asarray(dec))
    got = extract_reads(index, np.arange(40), n_strings=40)
    sreads, slens = sort_reads(reads, lens)
    for i in range(40):
        assert np.array_equal(got[i], sreads[i, : slens[i]]), i


def test_extract_subset_and_duplicates():
    reads_l = [np.array([1, 2, 3], np.uint8)] * 5 + [np.array([5, 4], np.uint8)]
    reads, lens = encode_reads(reads_l)
    dec = build_msbwt(reads, lens)
    index = build_occ_index(jnp.asarray(dec))
    got = extract_reads(index, [0, 4, 5], n_strings=6)
    assert np.array_equal(got[0], [1, 2, 3])
    assert np.array_equal(got[1], [1, 2, 3])
    assert np.array_equal(got[2], [5, 4])


def test_extract_bad_ids():
    reads, lens = encode_reads([np.array([1], np.uint8)])
    dec = build_msbwt(reads, lens)
    index = build_occ_index(jnp.asarray(dec))
    with pytest.raises(ValueError):
        extract_reads(index, [1], n_strings=1)


def test_locate_kmers_matches_bruteforce():
    """Every (read, offset) occurrence of each query must be reported
    exactly once, with read ids in the lexicographic (sorted-build) id
    space — cross-checked against a host brute-force scan."""
    from msbwt_jax.ops.extract import locate_kmers

    rng = np.random.default_rng(31)
    reads_l = [rng.integers(1, 6, rng.integers(4, 25)).astype(np.uint8)
               for _ in range(30)]
    reads, lens = encode_reads(reads_l)
    dec = build_msbwt(reads, lens)
    index = build_occ_index(jnp.asarray(dec))
    sreads, slens = sort_reads(reads, lens)

    K = 3
    kmers = np.stack([rng.integers(1, 6, K).astype(np.uint8)
                      for _ in range(8)])
    q, r, o = locate_kmers(index, kmers, n_strings=30)
    got = sorted(zip(q.tolist(), r.tolist(), o.tolist()))

    want = []
    for qi in range(8):
        pat = kmers[qi]
        for rid in range(30):
            row = sreads[rid, : slens[rid]]
            for off in range(len(row) - K + 1):
                if np.array_equal(row[off : off + K], pat):
                    want.append((qi, rid, off))
    assert got == sorted(want)


def test_locate_kmers_no_hits_and_duplicates():
    from msbwt_jax.ops.extract import locate_kmers

    reads_l = [np.array([1, 2, 3, 1, 2], np.uint8)] * 3
    reads, lens = encode_reads(reads_l)
    dec = build_msbwt(reads, lens)
    index = build_occ_index(jnp.asarray(dec))
    # absent k-mer -> empty result triple
    q, r, o = locate_kmers(index, np.array([[5, 5]], np.uint8), n_strings=3)
    assert q.size == r.size == o.size == 0
    # "AC" occurs twice in each of the 3 identical reads
    q, r, o = locate_kmers(index, np.array([[1, 2]], np.uint8), n_strings=3)
    assert sorted(zip(r.tolist(), o.tolist())) == [
        (0, 0), (0, 3), (1, 0), (1, 3), (2, 0), (2, 3)]


def test_locate_kmers_model_methods():
    """RleBWT.locate_kmers and DynamicBWT.locate_kmers agree with the op
    (same index, same id space) through the public model surface."""
    from msbwt_jax.models.dynamic import DynamicBWT
    from msbwt_jax.ops.extract import locate_kmers

    bwt = DynamicBWT()
    bwt.insert_strings(["ACGTA", "GGACG", "ACGAC"], sorted=True)
    kmers = np.array([[1, 2, 3]], np.uint8)  # "ACG"
    q1, r1, o1 = bwt.locate_kmers(kmers)
    q2, r2, o2 = locate_kmers(bwt.device_index, kmers, 3)
    assert (sorted(zip(r1.tolist(), o1.tolist()))
            == sorted(zip(r2.tolist(), o2.tolist())))
    # ACG occurs: ACGAC@0, ACGTA@0, GGACG@2 (ids 0,1,2 lexicographic)
    assert sorted(zip(r1.tolist(), o1.tolist())) == [(0, 0), (1, 0), (2, 2)]
