"""chip_smoke.py on the CPU: its phase functions at tiny size, and its
refusal to run where JAX finds no GPU (the script itself is run on a card)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _no_result_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "ok" in rec:
            return False
    return True


def test_refuses_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert _no_result_line(r.stdout)


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode != 0
    assert _no_result_line(r.stdout)


def test_host_counts_match_python_loop():
    reads = cs.make_reads(3, 60, genome_bases=400, read_len=30)
    kmers = cs.make_kmers(3, reads, 50)[:, :7]
    got = cs.host_counts(reads, kmers, chunk=17)
    text = ["".join(map(str, r)) for r in reads]
    for km, c in zip(kmers, got):
        pat = "".join(map(str, km))
        want = sum(
            sum(t.startswith(pat, i) for i in range(len(t) - len(pat) + 1))
            for t in text
        )
        assert c == want


def test_fastq_roundtrip(tmp_path):
    from msbwt_jax.utils.fastx import parse_fastx
    from msbwt_jax.ops.alphabet import convert_stoi

    reads = cs.make_reads(4, 1234, genome_bases=5000, read_len=40)
    path = str(tmp_path / "r.fq")
    cs.write_fastq(path, reads, chunk=500)
    back = np.stack([convert_stoi(s) for s in parse_fastx(path)])
    assert np.array_equal(back, reads)


def test_single_card_phases_tiny(tmp_path, capsys):
    smoke = cs.Smoke("cpu")
    reads = cs.make_reads(5, 1500, genome_bases=8000)
    kmers = cs.make_kmers(5, reads, 1000)
    npy = cs.phase_main_path(smoke, str(tmp_path), reads, kmers,
                             n_host=300, n_native=600)
    cs.phase_golden(smoke, str(tmp_path))
    cs.phase_oracle(smoke, 5, n=60)
    cs.phase_merge_pass(smoke, 5, reads.size + reads.shape[0],
                        reads.shape[0])
    cs.phase_engines(smoke, reads, npy)
    out = capsys.readouterr().out
    for name in ("host counts", "native reference loop", "golden", "oracle",
                 "engines"):
        assert f"PASS {name}:" in out
    assert "merge pass / copy time" in out


def test_multi_card_phase_tiny(capsys):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    smoke = cs.Smoke("cpu x4")
    reads = cs.make_reads(6, 400, genome_bases=3000, read_len=50)
    kmers = cs.make_kmers(6, reads, 300)
    cs.phase_multi(smoke, reads, kmers)
    out = capsys.readouterr().out
    for name in ("partitioned", "sharded merge (dense)",
                 "sharded merge (ragged)"):
        assert f"PASS {name}:" in out
