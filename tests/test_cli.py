"""CLI tests (mirrors the reference CLIs' behavior, src/bin/*.rs)."""

import gzip
import subprocess
import sys

import pytest

from msbwt_jax.cli.build import main as build_main
from msbwt_jax.cli.convert import main as convert_main
from msbwt_jax.utils.npy import load_bwt_bytes

from tests._data import GOLDEN_FA, GOLDEN_NPY  # noqa: E402


def test_build_golden_byte_identity(tmp_path):
    """The headline correctness contract: msbwt2-build output is
    byte-identical to the reference's checked-in npy."""
    out = tmp_path / "out.npy"
    rc = build_main(["-o", str(out), GOLDEN_FA])
    assert rc == 0
    assert out.read_bytes() == open(GOLDEN_NPY, "rb").read()


def test_build_stdout(tmp_path, capsys):
    rc = build_main([GOLDEN_FA])
    assert rc == 0
    # decoded golden body: [0d 09 0a 08 0b 09 0d 0a 0b 08] -> symbols
    assert capsys.readouterr().out.strip() == "TAC$GATCG$"


def test_build_missing_input(tmp_path):
    assert build_main(["-o", str(tmp_path / "x.npy"), "/nonexistent.fa"]) == 66


def test_build_fastq_gzip(tmp_path):
    fq = tmp_path / "reads.fq.gz"
    with gzip.open(fq, "wb") as fp:
        fp.write(b"@r1\nACGT\n+\nFFFF\n@r2\nTGCA\n+\nFFFF\n")
    out = tmp_path / "out.npy"
    assert build_main(["-o", str(out), str(fq)]) == 0
    assert out.read_bytes() == open(GOLDEN_NPY, "rb").read()


def test_convert_roundtrip(tmp_path):
    raw = tmp_path / "raw.txt"
    raw.write_text("GTN$$ACCC$G")
    out = tmp_path / "conv.npy"
    assert convert_main(["-i", str(raw), str(out)]) == 0
    assert load_bwt_bytes(str(out)).tolist() == [11, 13, 12, 16, 9, 26, 8, 11]


def test_convert_invalid_input(tmp_path):
    raw = tmp_path / "raw.txt"
    raw.write_text("GTB")
    assert convert_main(["-i", str(raw), str(tmp_path / "x.npy")]) == 74


def test_convert_stdin(tmp_path):
    out = tmp_path / "conv.npy"
    proc = subprocess.run(
        [sys.executable, "-m", "msbwt_jax.cli.convert", str(out)],
        input=b"ACGNT$", capture_output=True, cwd="/root/repo",
    )
    assert proc.returncode == 0, proc.stderr.decode()
    assert load_bwt_bytes(str(out)).tolist() == [9, 10, 11, 12, 13, 8]


def test_build_cli_streaming_batches(tmp_path):
    """--batch-size streams reads through the incremental builder and must
    produce byte-identical output."""
    out1 = tmp_path / "a.npy"
    out2 = tmp_path / "b.npy"
    assert build_main(["-o", str(out1), GOLDEN_FA]) == 0
    assert build_main(["-o", str(out2), "--batch-size", "1", GOLDEN_FA]) == 0
    assert out1.read_bytes() == out2.read_bytes()


def test_query_cli(tmp_path, capsys):
    from msbwt_jax.cli.query import main as query_main

    out = tmp_path / "q.npy"
    assert build_main(["-o", str(out), GOLDEN_FA]) == 0
    assert query_main([str(out), "ACGT", "TGCA", "$", "GGG"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["ACGT\t1", "TGCA\t1", "$\t2", "GGG\t0"]


def test_query_cli_locate(tmp_path, capsys):
    """--locate prints one (kmer, read_id, offset) line per occurrence;
    two_string.fa sorted = [ACGT, TGCA], so 'GC' hits only read 1 @1."""
    from msbwt_jax.cli.query import main as query_main

    out = tmp_path / "q.npy"
    assert build_main(["-o", str(out), GOLDEN_FA]) == 0
    assert query_main([str(out), "GC", "CG", "AA", "--locate"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["GC\t1", "CG\t1", "AA\t0",
                     "GC\t1\t1", "CG\t0\t1"]


def test_query_cli_max_mismatch(tmp_path, capsys):
    """--max-mismatch 1 counts single-substitution variants too: on
    two_string.fa (ACGT, TGCA), 'AGGT' has 0 exact hits but is 1 sub away
    from ACGT."""
    from msbwt_jax.cli.query import main as query_main

    out = tmp_path / "q.npy"
    assert build_main(["-o", str(out), GOLDEN_FA]) == 0
    assert query_main([str(out), "AGGT", "--max-mismatch", "1"]) == 0
    assert capsys.readouterr().out == "AGGT\t1\n"


def test_query_cli_from_file(tmp_path, capsys):
    from msbwt_jax.cli.query import main as query_main

    out = tmp_path / "q.npy"
    assert build_main(["-o", str(out), GOLDEN_FA]) == 0
    kf = tmp_path / "kmers.txt"
    kf.write_text("ACGT\nCA\n")
    assert query_main([str(out), "-i", str(kf), "--cache-k", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["ACGT\t1", "CA\t1"]


def test_query_cli_index_pack(tmp_path, capsys):
    """--index-pack saves derived indexes on the first run and loads them
    (skipping derivation) on the second; results identical."""
    from msbwt_jax.cli.query import main as query_main

    out = tmp_path / "q.npy"
    assert build_main(["-o", str(out), GOLDEN_FA]) == 0
    pack = tmp_path / "q.indexes.npz"
    args = [str(out), "ACGT", "TGCA", "$", "--cache-k", "2",
            "--index-pack", str(pack)]
    assert query_main(args) == 0
    first = capsys.readouterr().out
    assert pack.is_file()
    assert query_main(args) == 0
    assert capsys.readouterr().out == first == "ACGT\t1\nTGCA\t1\n$\t2\n"
    # a pack from a different BWT is rejected with IOERR (74)
    other = tmp_path / "other.npy"
    assert build_main(["-o", str(other), GOLDEN_FA, GOLDEN_FA]) == 0
    assert query_main([str(other), "ACGT", "--index-pack", str(pack)]) == 74


def test_query_cli_index_pack_extensionless(tmp_path, capsys):
    """A pack path without '.npz' still round-trips (np.savez extension
    trap), and a malformed pack exits IOERR instead of crashing."""
    import numpy as np

    from msbwt_jax.cli.query import main as query_main

    out = tmp_path / "q.npy"
    assert build_main(["-o", str(out), GOLDEN_FA]) == 0
    pack = tmp_path / "idx.pack"
    assert query_main([str(out), "ACGT", "--index-pack", str(pack)]) == 0
    capsys.readouterr()
    assert pack.is_file()  # exact name, no .npz appended
    assert query_main([str(out), "ACGT", "--index-pack", str(pack)]) == 0
    assert capsys.readouterr().out == "ACGT\t1\n"

    # malformed packs: plain npz without our arrays, and non-zip bytes
    bad = tmp_path / "bad.npz"
    np.savez(str(bad), junk=np.arange(3))
    assert query_main([str(out), "ACGT", "--index-pack", str(bad)]) == 74
    notzip = tmp_path / "notzip.npz"
    notzip.write_bytes(b"this is not a zip archive")
    assert query_main([str(out), "ACGT", "--index-pack", str(notzip)]) == 74


def test_query_cli_pack_gains_cache(tmp_path, capsys):
    """--cache-k on top of an already-loaded pack persists the new cache
    into the pack instead of rebuilding it every run."""
    from msbwt_jax.cli.query import main as query_main
    from msbwt_jax.utils.checkpoint import load_query_pack

    out = tmp_path / "q.npy"
    assert build_main(["-o", str(out), GOLDEN_FA]) == 0
    pack = tmp_path / "idx.npz"
    assert query_main([str(out), "ACGT", "--index-pack", str(pack)]) == 0
    _, _, cache, ck = load_query_pack(str(pack))
    assert cache is None and ck == 0
    assert query_main([str(out), "ACGT", "--index-pack", str(pack),
                       "--cache-k", "2"]) == 0
    _, _, cache, ck = load_query_pack(str(pack))
    assert cache is not None and ck == 2
    capsys.readouterr()


def test_query_cli_missing_bwt():
    from msbwt_jax.cli.query import main as query_main

    assert query_main(["/nonexistent.npy", "ACGT"]) == 66


def test_correct_cli(tmp_path, capsys):
    """msbwt2-correct repairs an injected error and passes short /
    ragged reads through untouched."""
    import numpy as np

    from msbwt_jax.cli.correct import main as correct_main
    from msbwt_jax.ops.alphabet import convert_itos

    rng = np.random.default_rng(7)
    genome = rng.integers(1, 6, 300).astype(np.uint8)
    genome[genome == 4] = 5
    L, n_reads = 60, 150
    starts = rng.integers(0, genome.size - L, n_reads)
    reads = [convert_itos(genome[s : s + L]) for s in starts]
    corpus_fa = tmp_path / "corpus.fa"
    corpus_fa.write_text("".join(f">r{i}\n{r}\n" for i, r in
                                 enumerate(reads)))
    bwt_npy = tmp_path / "c.npy"
    assert build_main(["-o", str(bwt_npy), str(corpus_fa)]) == 0

    truth = reads[0]
    broken = truth[:30] + {"A": "C", "C": "G", "G": "T", "T": "A"}[
        truth[30]] + truth[31:]
    in_fa = tmp_path / "in.fa"
    in_fa.write_text(f">bad\n{broken}\n>short\nACGT\n")
    out_fa = tmp_path / "out.fa"
    assert correct_main([str(bwt_npy), str(in_fa), "-o", str(out_fa)]) == 0
    lines = out_fa.read_text().strip().splitlines()
    # input record names are preserved (mate pairing / barcodes)
    assert lines == [">bad", truth, ">short", "ACGT"]

    # missing inputs -> NOINPUT; bad batch size -> NOINPUT (not a traceback)
    assert correct_main([str(bwt_npy), "/nonexistent.fa"]) == 66
    assert correct_main([str(bwt_npy), str(in_fa), "--batch-size", "0"]) == 66
    capsys.readouterr()


def test_extract_cli(tmp_path, capsys):
    from msbwt_jax.cli.extract import main as extract_main

    out = tmp_path / "e.npy"
    assert build_main(["-o", str(out), GOLDEN_FA]) == 0
    assert extract_main([str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    # two_string.fa holds ACGT and TGCA; sorted order is lexicographic
    assert lines == [">read_0", "ACGT", ">read_1", "TGCA"]
    assert extract_main([str(out), "1"]) == 0
    assert capsys.readouterr().out == ">read_1\nTGCA\n"


def test_build_distributed_byte_identity(tmp_path):
    """--distributed (single-process degenerate form over the virtual mesh)
    must produce the same byte-identical npy."""
    out = tmp_path / "dist.npy"
    rc = build_main(["--distributed", "-o", str(out), GOLDEN_FA])
    assert rc == 0
    assert out.read_bytes() == open(GOLDEN_NPY, "rb").read()


def test_build_distributed_rejects_unsorted(tmp_path):
    out = tmp_path / "dist2.npy"
    rc = build_main(["--distributed", "--unsorted", "-o", str(out), GOLDEN_FA])
    assert rc != 0  # chronological order is not defined across processes
