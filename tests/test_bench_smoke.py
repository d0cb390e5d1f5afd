"""bench.py delivery contract: ONE parseable JSON line on stdout.

An earlier bench measured everything and then crashed at the emit step
(``NameError``) — nothing had ever executed ``main()`` through ``emit()``.
This smoke runs the REAL bench end-to-end in ``--tiny`` mode on CPU so the
delivery path is exercised on every commit.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_tiny_emits_one_json_line():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--tiny"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected exactly one stdout line:\n{r.stdout}"
    rec = json.loads(lines[0])
    for field in ("metric", "value", "unit", "vs_baseline"):
        assert field in rec, field
    assert rec["value"] > 0
    assert rec["unit"] == "queries/s"
    assert rec["extra"]["toy_query_qps"] == rec["value"]  # tiny == toy path
    assert set(rec["device"]) == {"platform", "kind", "count"}
    assert rec["device"]["platform"] == "cpu" and rec["device"]["count"] >= 1


def test_bench_large_subprocess_plumbing():
    """The 505M leg runs in the bench's own process (one process per card);
    a stubbed run_large checks that its numbers reach the result line."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "MSBWT_BENCH_FAKE_LARGE": "1"}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--tiny"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected exactly one stdout line:\n{r.stdout}"
    rec = json.loads(lines[0])
    assert rec["extra"]["ecoli_505M"].get("fake") is True
    assert rec["value"] == 12345  # headline took the (stub) 505M number


def test_bench_no_retry_on_deterministic_errors():
    """The bench never starts a second process (a child would find the
    card's memory already reserved by the parent) and so never retries:
    a program error fails the run once, loudly."""
    src = open(os.path.join(REPO, "bench.py")).read()
    head = src.split("def main", 1)[0]
    assert "\nimport os\n" in head  # the round-3 crash: os used, never imported
    for spawner in ("subprocess", "multiprocessing", "os.fork", "os.exec"):
        assert spawner not in src, spawner
