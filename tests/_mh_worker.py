"""Worker for the 2-process multihost integration test.

Usage: python tests/_mh_worker.py <pid> <nproc> <port> <out_npy>
Builds the MSBWT of a fixed read set distributed across processes and
(process 0) writes the resulting comp_msbwt npy.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

pid, nproc, port, out_path = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
)
os.environ["MSBWT_COORDINATOR"] = f"127.0.0.1:{port}"
os.environ["MSBWT_NUM_PROCS"] = str(nproc)
os.environ["MSBWT_PROC_ID"] = str(pid)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# config forces cpu as well as the env var, and CPU cross-process
# collectives need gloo — all BEFORE backend init
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_cpu_collectives_implementation", "gloo")

from msbwt_jax.parallel.multihost import (  # noqa: E402
    build_msbwt_multihost,
    init_distributed,
    process_read_slice,
)

assert init_distributed(), "distributed init failed"
assert jax.process_count() == nproc, jax.process_count()
from msbwt_jax.utils.jaxcache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import numpy as np  # noqa: E402

from msbwt_jax.ops.bcr import encode_reads  # noqa: E402

rng = np.random.default_rng(1234)  # every process derives the same read set
reads_l = [rng.integers(1, 6, rng.integers(3, 22)).astype(np.uint8)
           for _ in range(37)]
sl = process_read_slice(len(reads_l))
reads, lengths = encode_reads(reads_l[sl])
decoded = build_msbwt_multihost(reads, lengths)

if jax.process_index() == 0:
    from msbwt_jax.ops.rle import runs_from_symbols
    from msbwt_jax.utils.npy import save_bwt_runs

    save_bwt_runs(*runs_from_symbols(decoded), out_path)
print(f"[p{pid}] ok n={decoded.size}", flush=True)
