"""chr21-shaped flow rehearsal as ONE command across REAL processes.

BASELINE.json config 5 composes: multi-host build -> distributed merge ->
sharded export -> pod-wide query fan-out. The pieces are tested separately
(tests/test_multihost_procs.py builds, tests/test_sharded.py composes wide);
this driver rehearses the WHOLE flow end-to-end across 2..4 actual
``jax.distributed`` processes (gloo CPU collectives, 2 devices each) with
``force_wide=True`` (the int64 position mode chr21's ~5G symbols needs —
u64 contract: ref src/msbwt_core.rs:124), and reports machine-readable
pass/fail plus per-phase timings.

Usage:  python benchmarks/rehearsal.py [--procs 2] [--reads 240]
Output: ONE JSON line on stdout:
  {"ok": true, "procs": 2, "n_symbols": ..., "phases": {"build_s": ...,
   "merge_s": ..., "export_s": ..., "reload_s": ..., "query_s": ...}}

Phases (every process; process 0 owns export):
  build   - per-device BCR builds of this process's read stripe
  merge   - distributed prefix-doubling D-way merge over the GLOBAL mesh
            (parallel.doubling_merge, multi-process arrays), wide mode
  export  - process 0: sharded npy checkpoint (utils.checkpoint)
  reload  - every process reloads the sharded checkpoint
  query   - batched count_kmer over the wide sharded index spanning all
            processes' devices, checked against the substring oracle
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------- worker ----

def _worker() -> int:
    pid = int(os.environ["_MSBWT_REH_PID"])
    nproc = int(os.environ["_MSBWT_REH_NPROC"])
    port = os.environ["_MSBWT_REH_PORT"]
    out_dir = os.environ["_MSBWT_REH_OUT"]
    n_reads = int(os.environ["_MSBWT_REH_READS"])

    os.environ["MSBWT_COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["MSBWT_NUM_PROCS"] = str(nproc)
    os.environ["MSBWT_PROC_ID"] = str(pid)
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from msbwt_jax.parallel.multihost import (
        init_distributed,
        process_read_slice,
    )

    assert init_distributed(), "distributed init failed"
    assert jax.process_count() == nproc
    from msbwt_jax.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    from msbwt_jax.ops.alphabet import convert_itos, convert_stoi
    from msbwt_jax.ops.bcr import build_msbwt, encode_reads
    from msbwt_jax.parallel.doubling_merge import sharded_doubling_merge
    from msbwt_jax.parallel.mesh import default_mesh
    from msbwt_jax.parallel.sharded_index import (
        build_sharded_index,
        count_kmers_sharded,
    )
    from msbwt_jax.utils.checkpoint import load_sharded, save_sharded
    from msbwt_jax.utils.oracle import naive_bwt

    phases: dict[str, float] = {}
    mesh = default_mesh()  # global: nproc x 2 devices
    n_local = jax.local_device_count()

    # every process derives the same collection; each builds only its stripe
    rng = np.random.default_rng(0xC821)
    reads_l = [rng.integers(1, 6, rng.integers(4, 28)).astype(np.uint8)
               for _ in range(n_reads)]
    sl = process_read_slice(len(reads_l))
    mine = reads_l[sl]

    # --- build: one BCR build per local device chunk ---------------------
    t0 = time.perf_counter()
    per = -(-len(mine) // n_local)
    parts_local = []
    for d in range(n_local):
        chunk = mine[d * per: (d + 1) * per]
        if chunk:
            reads, lengths = encode_reads(chunk)
            parts_local.append(np.asarray(build_msbwt(reads, lengths)))
        else:
            parts_local.append(np.zeros(0, np.uint8))
    phases["build_s"] = time.perf_counter() - t0

    # --- merge: exchange partial BWTs, wide doubling merge on global mesh -
    t0 = time.perf_counter()
    sizes_loc = np.array([p.size for p in parts_local], np.int32)
    sizes_all = np.asarray(
        multihost_utils.process_allgather(jnp.asarray(sizes_loc))
    ).reshape(nproc, n_local)
    cap = int(sizes_all.max())
    stacked = np.zeros((n_local, cap), np.uint8)
    for d, p in enumerate(parts_local):
        stacked[d, : p.size] = p
    parts_all = np.asarray(
        multihost_utils.process_allgather(jnp.asarray(stacked))
    ).reshape(nproc, n_local, cap)
    parts = [parts_all[p, d, : sizes_all[p, d]]
             for p in range(nproc) for d in range(n_local)]
    merged = sharded_doubling_merge(parts, mesh=mesh, force_wide=True)
    phases["merge_s"] = time.perf_counter() - t0

    want = naive_bwt([convert_itos(r) for r in reads_l])
    assert convert_itos(merged) == want, "merged BWT != oracle"

    # --- export (process 0) + barrier -------------------------------------
    t0 = time.perf_counter()
    if pid == 0:
        save_sharded(merged, out_dir, n_shards=nproc * n_local)
    multihost_utils.sync_global_devices("rehearsal_export")
    phases["export_s"] = time.perf_counter() - t0

    # --- reload ------------------------------------------------------------
    t0 = time.perf_counter()
    reloaded = load_sharded(out_dir)
    assert np.array_equal(reloaded, merged)
    phases["reload_s"] = time.perf_counter() - t0

    # --- query fan-out over the global wide sharded index ------------------
    t0 = time.perf_counter()
    idx = build_sharded_index(reloaded, mesh, force_wide=True)
    strings = [convert_itos(r) for r in reads_l]
    queries = [s[: min(len(s), 5)] for s in strings[:: max(1, n_reads // 32)]]
    K = max(len(q) for q in queries)
    kmers = np.zeros((len(queries), K), np.uint8)
    qlens = np.array([len(q) for q in queries], np.int32)
    for i, q in enumerate(queries):
        kmers[i, K - len(q):] = convert_stoi(q)
    got = count_kmers_sharded(idx, kmers, qlens)
    for i, q in enumerate(queries):
        # overlapping-occurrence oracle (str.count is non-overlapping)
        cnt = sum(
            s[j: j + len(q)] == q
            for s in strings for j in range(len(s) - len(q) + 1)
        )
        assert got[i] == cnt, (q, int(got[i]), cnt)
    phases["query_s"] = time.perf_counter() - t0

    rec = {
        "ok": True,
        "procs": nproc,
        "devices": nproc * n_local,
        "n_symbols": int(merged.size),
        "wide": True,
        "n_queries": len(queries),
        "phases": {k: round(v, 3) for k, v in phases.items()},
    }
    print(f"REHEARSAL_RESULT {json.dumps(rec)}", flush=True)
    return 0


# --------------------------------------------------------------- parent ----

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    procs = 2
    n_reads = 240
    if "--procs" in argv:
        procs = int(argv[argv.index("--procs") + 1])
    if "--reads" in argv:
        n_reads = int(argv[argv.index("--reads") + 1])

    out_dir = tempfile.mkdtemp(prefix="msbwt_rehearsal_")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update({
        "_MSBWT_REH_NPROC": str(procs),
        "_MSBWT_REH_PORT": str(port),
        "_MSBWT_REH_OUT": out_dir,
        "_MSBWT_REH_READS": str(n_reads),
    })
    children = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)],
            env={**env, "_MSBWT_REH_PID": str(i)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
        )
        for i in range(procs)
    ]
    logs, ok, rec = [], True, None
    # worker budget < every caller's subprocess budget (tests and
    # __graft_entry__ wrap this script in an 840 s timeout): if the outer
    # kill fired first, the gloo worker children would be orphaned holding
    # the coordinator port and CPU
    for i, c in enumerate(children):
        try:
            out_b, _ = c.communicate(timeout=700)
        except subprocess.TimeoutExpired:
            c.kill()
            out_b = b"(timeout)"
        text = out_b.decode(errors="replace")
        logs.append(text)
        if c.returncode != 0:
            ok = False
            print(f"--- worker {i} rc={c.returncode} ---\n{text[-3000:]}",
                  file=sys.stderr)
            # a failed/hung worker means the gloo rendezvous can never
            # complete — reap the remaining children instead of waiting out
            # their full budgets one by one
            for other in children:
                if other.poll() is None:
                    other.kill()
        for line in text.splitlines():
            if line.startswith("REHEARSAL_RESULT ") and i == 0:
                rec = json.loads(line.split(" ", 1)[1])
    if rec is None:
        ok = False
        rec = {"ok": False, "procs": procs, "error": "no result from worker 0"}
    rec["ok"] = bool(ok and rec.get("ok"))
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    if "_MSBWT_REH_PID" in os.environ:
        sys.path.insert(0, REPO)
        sys.exit(_worker())
    sys.exit(main())
