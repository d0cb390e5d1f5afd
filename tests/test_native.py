"""Native host library (C++) parity vs the Python paths."""

import gzip

import numpy as np
import pytest

from msbwt_jax.ops.alphabet import convert_stoi
from msbwt_jax.ops.rle import bytes_from_runs, runs_from_bytes, runs_from_symbols
from msbwt_jax.utils.fastx import parse_fastx
from msbwt_jax.utils import native


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def test_rle_decode_parity(lib, rng):
    syms = rng.integers(0, 6, 50).astype(np.uint8)
    for i in range(1, 50):
        if syms[i] == syms[i - 1]:
            syms[i] = (syms[i] + 1) % 6
    counts = rng.integers(1, 100000, 50).astype(np.uint64)
    enc = bytes_from_runs(syms, counts)
    dec = native.rle_decode_native(enc)
    assert dec.tolist() == np.repeat(syms, counts.astype(np.int64)).tolist()


def test_rle_encode_parity(lib, rng):
    decoded = rng.integers(0, 6, 10000).astype(np.uint8)
    enc_native = native.rle_encode_native(decoded)
    enc_py = bytes_from_runs(*runs_from_symbols(decoded))
    assert enc_native.tolist() == enc_py.tolist()
    s, c = runs_from_bytes(enc_native)
    assert np.repeat(s, c.astype(np.int64)).tolist() == decoded.tolist()


def test_parse_fasta_parity(lib, tmp_path):
    fa = tmp_path / "t.fa"
    fa.write_text(">r1\nACGT\nacgt\n>r2\nNNN\n>r3\nuUgG\n")
    got = native.parse_fastx_native(str(fa))
    want = [convert_stoi(s) for s in parse_fastx(str(fa))]
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert got[2].tolist() == [5, 5, 3, 3]  # U/u -> T


def test_parse_fastq_gzip_parity(lib, tmp_path):
    fq = tmp_path / "t.fq.gz"
    with gzip.open(fq, "wb") as fp:
        fp.write(b"@r1\nACGT\n+\nFFFF\n@r2 desc\nTTnn\n+x\n!!!!\n")
    got = native.parse_fastx_native(str(fq))
    want = [convert_stoi(s) for s in parse_fastx(str(fq))]
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert len(got) == 2


def test_parse_golden_two_string(lib):
    from tests._data import GOLDEN_FA
    got = native.parse_fastx_native(GOLDEN_FA)
    assert [g.tolist() for g in got] == [[1, 2, 3, 5], [5, 3, 2, 1]]


def test_parse_missing_file(lib):
    with pytest.raises(ValueError):
        native.parse_fastx_native("/nonexistent/file.fa")


def test_sort_rows_native_matches_numpy():
    from msbwt_jax.utils.native import sort_rows_native

    rng = np.random.default_rng(11)
    reads = rng.integers(0, 6, size=(3000, 23)).astype(np.uint8)
    order = sort_rows_native(reads)
    if order is None:
        pytest.skip("native toolchain unavailable")
    want = np.argsort(
        reads.view(np.dtype((np.void, reads.shape[1]))).ravel(), kind="stable"
    )
    assert np.array_equal(order, want.astype(np.int32))


def test_reads_to_cols_native_matches_python():
    from msbwt_jax.ops.bcr import reads_to_cols
    from msbwt_jax.utils.native import reads_to_cols_native, sort_rows_native

    rng = np.random.default_rng(13)
    L = 19
    reads = np.zeros((500, L), np.uint8)
    lengths = rng.integers(1, L + 1, 500).astype(np.int32)
    for i, l in enumerate(lengths):
        reads[i, :l] = rng.integers(1, 6, l)
    order = sort_rows_native(reads)
    if order is None:
        pytest.skip("native toolchain unavailable")
    got = reads_to_cols_native(reads, lengths, order)
    want = reads_to_cols(reads[order], lengths[order])
    assert np.array_equal(got, want)
    # identity order
    got2 = reads_to_cols_native(reads, lengths, None)
    assert np.array_equal(got2, reads_to_cols(reads, lengths))


# --- native CPU baseline (csrc/msbwt_baseline.cpp) ---------------------------


def test_baseline_build_matches_oracle(rng):
    from msbwt_jax.ops.alphabet import convert_itos, convert_stoi
    from msbwt_jax.utils.native import baseline_build_native
    from msbwt_jax.utils.oracle import naive_bwt

    data = ["".join(rng.choice(list("ACGNT"), size=rng.integers(3, 28)))
            for _ in range(120)]
    data += data[:15]  # duplicates exercise the short-circuit dup branch
    got = baseline_build_native([convert_stoi(s) for s in data],
                                sorted_insert=True)
    if got is None:
        import pytest
        pytest.skip("no native toolchain")
    assert convert_itos(got) == naive_bwt(data)


def test_baseline_build_chronological():
    from msbwt_jax.ops.alphabet import convert_stoi
    from msbwt_jax.utils.native import baseline_build_native

    # the reference's insert_string doctest (ref: src/dynamic_bwt.rs:295-302)
    got = baseline_build_native([convert_stoi("ACGNT")], sorted_insert=False)
    if got is None:
        import pytest
        pytest.skip("no native toolchain")
    assert got.tolist() == [5, 0, 1, 2, 3, 4]


def test_baseline_queries_match_engine(rng):
    import jax.numpy as jnp

    from msbwt_jax.ops.alphabet import convert_stoi
    from msbwt_jax.ops.rank import build_occ_index, count_kmers
    from msbwt_jax.ops.rle import bytes_from_runs, runs_from_symbols
    from msbwt_jax.utils.native import baseline_count_kmers_native
    from msbwt_jax.utils.oracle import naive_bwt

    data = ["".join(rng.choice(list("ACGT"), size=20)) for _ in range(80)]
    dec = np.asarray(convert_stoi(naive_bwt(data)), np.uint8)
    rle = bytes_from_runs(*runs_from_symbols(dec))
    B, K = 300, 9
    kmers = rng.integers(0, 6, size=(B, K)).astype(np.uint8)
    lens = rng.integers(1, K + 1, B).astype(np.int32)
    for i in range(B):
        kmers[i, : K - lens[i]] = 0
    want = count_kmers(build_occ_index(jnp.asarray(dec)), kmers, lens)
    for bp in (2, 8):
        got = baseline_count_kmers_native(rle, kmers, lens, bin_power=bp)
        if got is None:
            import pytest
            pytest.skip("no native toolchain")
        assert got.tolist() == want.tolist()
