"""fmlrc-style correction demo (apps.correct): the flagship application of
the original msbwt, driven through the batched device query path."""

import numpy as np
import pytest

from msbwt_jax.apps import correct_reads, flag_read_errors
from msbwt_jax.models.dynamic import DynamicBWT
from msbwt_jax.ops.alphabet import convert_itos


@pytest.fixture(scope="module")
def corpus():
    """~30x coverage of a 300bp genome + 5 reads with one injected error.

    Reads TILE the genome at stride 2, and each tiled read is inserted TWICE:
    every k=21 window of every in-index read then occurs >= 2 times by
    construction (random starts gave genome-edge windows coverage 1 with
    probability that depended on the shared session RNG's state — the round-3
    flake), so the clean-read assertion is deterministic. Fixed local seed
    keeps the corpus independent of fixture/xdist ordering."""
    rng = np.random.default_rng(0xC0FFEE)
    genome = rng.integers(1, 6, 300).astype(np.uint8)
    genome[genome == 4] = 5  # drop N so substitutions are unambiguous
    L = 60
    starts = np.arange(0, genome.size - L + 1, 2)
    reads = np.repeat(
        np.stack([genome[s : s + L] for s in starts]), 2, axis=0
    )
    bwt = DynamicBWT()
    bwt.insert_strings([convert_itos(r) for r in reads], sorted=True)

    test_reads = reads[:5].copy()
    err_pos = [10, 30, 45, 5, 55]
    truth = test_reads.copy()
    for i, p in enumerate(err_pos):
        orig = test_reads[i, p]
        alt = {1: 2, 2: 3, 3: 5, 5: 1}[int(orig)]
        test_reads[i, p] = alt
    return bwt, test_reads, truth, err_pos


def test_flags_find_injected_errors(corpus):
    bwt, test_reads, truth, err_pos = corpus
    flags = flag_read_errors(bwt, test_reads, k=21, tau=2)
    for i, p in enumerate(err_pos):
        assert flags[i, p], f"read {i}: injected error at {p} not flagged"
    # clean reads (in the index) must be flag-free
    clean = flag_read_errors(bwt, truth, k=21, tau=2)
    assert not clean.any()


def test_correction_repairs_errors(corpus):
    bwt, test_reads, truth, err_pos = corpus
    fixed, n = correct_reads(bwt, test_reads, k=21, tau=2)
    assert n >= len(err_pos)
    for i, p in enumerate(err_pos):
        assert fixed[i, p] == truth[i, p], f"read {i} base {p} not repaired"
    # repaired reads carry no remaining flags at the error sites
    flags = flag_read_errors(bwt, fixed, k=21, tau=2)
    for i, p in enumerate(err_pos):
        assert not flags[i, p]


def test_correction_cap(corpus):
    bwt, test_reads, _truth, _err_pos = corpus
    _fixed, n = correct_reads(bwt, test_reads, k=21, tau=2,
                              max_corrections_per_read=0)
    assert n == 0


def test_correction_chunked_scoring_matches(corpus):
    """suspect_chunk bounds the per-device-call candidate fan-out; a tiny
    chunk size must change nothing but the number of batched calls."""
    bwt, test_reads, _truth, _err_pos = corpus
    fixed_a, n_a = correct_reads(bwt, test_reads, k=21, tau=2)
    fixed_b, n_b = correct_reads(bwt, test_reads, k=21, tau=2,
                                 suspect_chunk=3)
    assert n_a == n_b
    assert np.array_equal(fixed_a, fixed_b)
    with pytest.raises(ValueError):
        correct_reads(bwt, test_reads, k=21, tau=2, suspect_chunk=0)


def test_correction_edge_positions(corpus):
    """Errors at the first and last base (single covering window, window
    clipping at both read edges) are scored and repaired."""
    bwt, _test_reads, truth, _err_pos = corpus
    broken = truth[:2].copy()
    alt = {1: 2, 2: 3, 3: 5, 5: 1}
    broken[0, 0] = alt[int(broken[0, 0])]
    broken[1, -1] = alt[int(broken[1, -1])]
    fixed, n = correct_reads(bwt, broken, k=21, tau=2)
    assert n >= 2
    assert fixed[0, 0] == truth[0, 0]
    assert fixed[1, -1] == truth[1, -1]
