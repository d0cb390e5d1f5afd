"""REAL 2-process multihost build: two `jax.distributed` processes (gloo CPU
collectives, 2 devices each -> a 4-device global mesh) build disjoint read
stripes and the distributed merge produces the canonical MSBWT.

This is the closest off-pod exercise of the multi-host layer: actual
cross-process collectives, process-local global-array assembly
(`make_array_from_process_local_data`), and process-0 output.
"""

import os
import socket
import subprocess
import sys

import numpy as np


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_build_matches_oracle(tmp_path):
    from msbwt_jax.ops.alphabet import convert_itos
    from msbwt_jax.utils.npy import load_bwt_bytes
    from msbwt_jax.utils.oracle import naive_bwt
    from msbwt_jax.ops.rle import decode_symbols

    out = tmp_path / "mh.npy"
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "_mh_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS",)}  # workers set their own device count
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        out_b, _ = p.communicate(timeout=540)
        logs.append(out_b.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-2000:]}"

    # same seed as the worker: reconstruct the expected collection
    rng = np.random.default_rng(1234)
    reads_l = [rng.integers(1, 6, rng.integers(3, 22)).astype(np.uint8)
               for _ in range(37)]
    want = naive_bwt([convert_itos(r) for r in reads_l])
    got = convert_itos(decode_symbols(load_bwt_bytes(str(out))))
    assert got == want
