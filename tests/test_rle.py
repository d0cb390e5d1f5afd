"""RLE codec tests (mirrors ref: src/bwt_converter.rs:186-257 boundary cases)."""

import numpy as np
import pytest

from msbwt_jax.ops.rle import (
    bytes_from_runs,
    convert_to_vec,
    decode_symbols,
    runs_from_bytes,
    runs_from_symbols,
    symbol_counts_from_bytes,
)
from msbwt_jax.utils.oracle import naive_bwt


def test_convert_to_vec_simple():
    # ref: src/bwt_converter.rs:194-206
    vec = convert_to_vec("ACGNT$")
    assert vec.tolist() == [8 + 1, 8 + 2, 8 + 3, 8 + 4, 8 + 5, 8 + 0]


def test_newline_tolerance():
    # newlines at start/end/mid-run/between chars; runs continue across them
    # (ref: src/bwt_converter.rs:209-217)
    vec = convert_to_vec("\n$$\n$$\nAAA\n")
    assert vec.tolist() == [(4 << 3) + 0, (3 << 3) + 1]


def test_invalid_symbol_raises():
    with pytest.raises(ValueError):
        convert_to_vec("ACGTB")


def test_compression_multibyte():
    # ref: src/bwt_converter.rs:220-243
    vec = convert_to_vec("A" * (32 + 32 * 32 * 3))
    assert vec.tolist() == [1, 9, 1 + (3 << 3)]  # digits 0,1,3 — zero digit legal

    vec = convert_to_vec("A" * 31 + "C" * 31)
    assert vec.tolist() == [249, 250]

    vec = convert_to_vec("N" * 32767)
    assert vec.tolist() == [4 + (0x1F << 3)] * 3


def test_bwt_conversion_golden():
    # ref: src/bwt_converter.rs:246-256
    bwt = naive_bwt(["CCGT", "N", "ACG"])
    assert bwt == "GTN$$ACCC$G"
    vec = convert_to_vec(bwt)
    assert vec.tolist() == [11, 13, 12, 16, 9, 26, 8, 11]


def test_runs_round_trip():
    syms = np.array([1, 0, 2, 1], dtype=np.uint8)
    counts = np.array([3104, 1, 32767, 32], dtype=np.uint64)
    enc = bytes_from_runs(syms, counts)
    s2, c2 = runs_from_bytes(enc)
    assert s2.tolist() == syms.tolist()
    assert c2.tolist() == counts.tolist()
    # count=32 emits digits [0,1]
    assert enc[-2:].tolist() == [1 + (0 << 3), 1 + (1 << 3)]


def test_decode_symbols_and_totals():
    vec = convert_to_vec("GTN$$ACCC$G")
    assert decode_symbols(vec).tolist() == [3, 5, 4, 0, 0, 1, 2, 2, 2, 0, 3]
    assert symbol_counts_from_bytes(vec).tolist() == [3, 1, 3, 2, 1, 1]


def test_runs_from_symbols():
    syms, counts = runs_from_symbols(np.array([1, 1, 0, 0, 2], dtype=np.uint8))
    assert syms.tolist() == [1, 0, 2]
    assert counts.tolist() == [2, 2, 1]


def test_empty():
    assert convert_to_vec("").size == 0
    s, c = runs_from_bytes(np.zeros(0, dtype=np.uint8))
    assert s.size == 0 and c.size == 0


def test_random_round_trip(rng):
    for _ in range(20):
        n_runs = int(rng.integers(1, 200))
        syms = rng.integers(0, 6, n_runs).astype(np.uint8)
        # forbid adjacent equal symbols (format invariant, ref bwt_converter.rs:136)
        for i in range(1, n_runs):
            if syms[i] == syms[i - 1]:
                syms[i] = (syms[i] + 1) % 6
        counts = rng.integers(1, 100000, n_runs).astype(np.uint64)
        s2, c2 = runs_from_bytes(bytes_from_runs(syms, counts))
        assert s2.tolist() == syms.tolist()
        assert c2.tolist() == counts.tolist()


def test_rle_meta_chunked_parity(rng):
    from msbwt_jax.ops.rle import rle_meta

    for _ in range(10):
        n_runs = int(rng.integers(1, 300))
        syms = rng.integers(0, 6, n_runs).astype(np.uint8)
        for i in range(1, n_runs):
            if syms[i] == syms[i - 1]:
                syms[i] = (syms[i] + 1) % 6
        counts = rng.integers(1, 200000, n_runs).astype(np.uint64)
        vec = bytes_from_runs(syms, counts)
        # tiny chunk: every boundary exercises the run-aligned extension
        n, tot, r = rle_meta(vec, chunk=7)
        assert n == int(counts.sum())
        assert tot.tolist() == symbol_counts_from_bytes(vec).tolist()
        assert r == n_runs


def test_decode_symbols_device_parity(rng):
    from msbwt_jax.ops.rle import decode_symbols_device, rle_meta

    for _ in range(6):
        n_runs = int(rng.integers(1, 120))
        syms = rng.integers(0, 6, n_runs).astype(np.uint8)
        for i in range(1, n_runs):
            if syms[i] == syms[i - 1]:
                syms[i] = (syms[i] + 1) % 6
        # include multi-digit runs (zero interior digits) and singletons
        counts = rng.integers(1, 40000, n_runs).astype(np.uint64)
        vec = bytes_from_runs(syms, counts)
        n, _, _ = rle_meta(vec)
        dev = np.asarray(decode_symbols_device(vec, n))
        assert np.array_equal(dev, decode_symbols(vec))


def test_decode_symbols_device_chunked_upload():
    from msbwt_jax.ops.rle import _upload_bytes, decode_symbols

    vec = convert_to_vec("GTN$$ACCC$G" * 50)
    dev = np.asarray(_upload_bytes(vec, chunk=13))
    assert np.array_equal(dev, vec)


def test_decode_symbols_device_empty():
    from msbwt_jax.ops.rle import decode_symbols_device

    assert np.asarray(decode_symbols_device(np.zeros(0, np.uint8), 0)).size == 0
