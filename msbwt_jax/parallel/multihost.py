"""Multi-host (multi-process) entry point — the distributed-communication
layer the reference does not have (SURVEY.md §1: "README itself states the
builder is not parallelized", ref: README.md:42; this is the net-new layer).

Design: one JAX process per host. ``jax.distributed.initialize`` wires the
processes into one runtime; every collective in ``parallel/`` (psum,
all_gather, ragged_all_to_all) then spans the GLOBAL device set — within a
host over the card interconnect, across hosts over the network — with no
further code changes,
because all sharded programs here are written against a ``Mesh`` over
``jax.devices()`` (which is global once distributed init ran).

Work split:

* ingestion — each process parses its contiguous stripe of the input files
  (``process_read_slice``); nothing is exchanged on host.
* build — every device (local to each process) builds the BWT of its read
  chunk with the BCR core; the Holt–McMillan merge is order-independent and
  exact on rotation order, so NO global read sort is needed across hosts —
  the distributed D-way merge (``parallel.sharded_merge``, ragged
  transport) produces the canonical MSBWT whatever the read distribution.
* output — process 0 assembles the merged shards
  (``multihost_utils.process_allgather``) and writes the npy.

Launch recipe (one process per host):

  # clusters JAX detects (SLURM, ...): initialize() finds the topology
  msbwt2-build --distributed -o out.npy reads.fq.gz

  # manual / CPU clusters: point every process at the coordinator
  MSBWT_COORDINATOR=host0:8476 MSBWT_NUM_PROCS=2 MSBWT_PROC_ID=0 \
      msbwt2-build --distributed -o out.npy reads.fq.gz   # on host0
  MSBWT_COORDINATOR=host0:8476 MSBWT_NUM_PROCS=2 MSBWT_PROC_ID=1 \
      msbwt2-build --distributed -o out.npy reads.fq.gz   # on host1

Single-process invocations (tests, the driver's virtual-mesh dryrun) skip
``jax.distributed`` and run the same code path over the local devices.
"""

from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger("msbwt_jax")


def init_distributed() -> bool:
    """Initialize ``jax.distributed`` from the environment (idempotent).

    Returns True if a multi-process runtime is active. Priority: explicit
    ``MSBWT_COORDINATOR``/``MSBWT_NUM_PROCS``/``MSBWT_PROC_ID`` env vars;
    else ``jax.distributed.initialize()`` auto-detection when a cluster
    environment (SLURM, ...) is present; else single-process
    no-op. Must run before anything touches the XLA backend. On CPU
    clusters also set ``jax.config.update("jax_cpu_collectives_implementation",
    "gloo")`` (see tests/test_multihost_procs.py for a working 2-process
    launch).
    """
    import jax
    from jax._src import distributed as _dist

    if _dist.global_state.client is not None:  # already initialized
        return _dist.global_state.num_processes > 1

    coord = os.environ.get("MSBWT_COORDINATOR")
    if coord:
        nproc = int(os.environ["MSBWT_NUM_PROCS"])
        pid = int(os.environ["MSBWT_PROC_ID"])
        jax.distributed.initialize(
            coordinator_address=coord, num_processes=nproc, process_id=pid
        )
        logger.info("jax.distributed: process %d/%d via %s", pid, nproc, coord)
        return True
    try:  # auto-detection (SLURM, ...)
        from jax._src.clusters import ClusterEnv

        if ClusterEnv.auto_detect_unset_distributed_params()[0] is not None:
            jax.distributed.initialize()
            logger.info(
                "jax.distributed: auto-initialized process %d/%d",
                jax.process_index(), jax.process_count(),
            )
            return True
    except Exception:
        pass
    return False


def process_read_slice(n_records: int, process_id: int | None = None,
                       num_processes: int | None = None) -> slice:
    """Contiguous stripe of record indices owned by this process."""
    import jax

    pid = jax.process_index() if process_id is None else process_id
    nproc = jax.process_count() if num_processes is None else num_processes
    per = -(-n_records // nproc)
    return slice(pid * per, min((pid + 1) * per, n_records))


def build_msbwt_multihost(reads: np.ndarray, lengths: np.ndarray,
                          mesh=None) -> np.ndarray:
    """MSBWT of this process's read stripe + every other process's stripe.

    ``reads``/``lengths`` are THIS process's stripe (already sliced with
    :func:`process_read_slice`). Per-device BCR builds run data-parallel
    over the local devices of every process; the cross-host combine is the
    distributed D-way H-M merge over the global mesh. Returns the full
    decoded BWT on every process.

    The H-M merge is exact on rotation order whatever the read
    distribution, so no cross-host read sort is needed — each device builds
    the partial BWT of whatever reads its process handed it, and the merge
    canonicalizes (tested 2-process in tests/test_multihost_procs.py).
    """
    import jax

    from msbwt_jax.parallel.mesh import default_mesh
    from msbwt_jax.parallel.sharded_build import build_msbwt_sharded

    if mesh is None:
        mesh = default_mesh()  # global devices once distributed init ran
    if jax.process_count() == 1:
        return build_msbwt_sharded(reads, lengths, mesh=mesh, merge="sharded")
    return _build_multiprocess(reads, lengths, mesh)


def _build_multiprocess(reads, lengths, mesh) -> np.ndarray:
    """True multi-process SPMD build: every process holds only its stripe;
    global arrays are assembled shard-wise (``make_array_from_process_local_data``),
    the per-shard BCR and the D-way merge run as ONE global program each,
    and the merged result is gathered host-side on every process."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from msbwt_jax.ops.bcr import reads_to_cols, sort_reads
    from msbwt_jax.parallel.mesh import AXIS
    from msbwt_jax.parallel.sharded_build import _shardwise_bcr
    from msbwt_jax.parallel.sharded_merge import _sharded_merge_impl

    D = mesh.devices.size
    n_local_dev = len([d for d in mesh.devices.flat if d.process_index ==
                       jax.process_index()])
    reads = np.asarray(reads, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    # agree on global geometry: per-process (N, L) -> padded maxima
    geom = multihost_utils.process_allgather(
        jnp.asarray([reads.shape[0], reads.shape[1]], jnp.int32)
    )
    geom = np.asarray(geom).reshape(-1, 2)
    L = int(geom[:, 1].max())
    if reads.shape[1] < L:
        reads = np.pad(reads, ((0, 0), (0, L - reads.shape[1])))
    # local per-device chunks (sorted locally — merge canonicalizes order)
    reads, lengths = sort_reads(reads, lengths)
    N = reads.shape[0]
    # every process must use the SAME per-device row count; processes may
    # own different numbers of local devices, so divide each process's
    # record count by ITS device count (derivable from the mesh, no comm)
    proc_ids = np.asarray([dv.process_index for dv in mesh.devices.flat])
    dev_per_proc = np.bincount(proc_ids, minlength=jax.process_count())
    Nl = int(max(
        -(-int(geom[p, 0]) // int(dev_per_proc[p]))
        for p in range(jax.process_count())
    ))
    pad = n_local_dev * Nl - N
    if pad:
        reads = np.vstack([reads, np.zeros((pad, L), np.uint8)])
        lengths = np.concatenate([lengths, np.full(pad, -1, np.int32)])
    lengths_loc = lengths.reshape(n_local_dev, Nl)
    cols_loc = np.stack([
        reads_to_cols(reads[d * Nl : (d + 1) * Nl], lengths_loc[d])
        for d in range(n_local_dev)
    ])  # [D_local, L+2, Nl]

    sh3 = NamedSharding(mesh, P(AXIS, None, None))
    sh2 = NamedSharding(mesh, P(AXIS, None))
    cols_g = jax.make_array_from_process_local_data(
        sh3, cols_loc, (D, L + 2, Nl)
    )
    lengths_g = jax.make_array_from_process_local_data(
        sh2, lengths_loc, (D, Nl)
    )
    # global shard sizes (tiny; replicated via allgather)
    sizes_loc = np.where(lengths_loc >= 0, lengths_loc + 1, 0).sum(
        axis=1
    ).astype(np.int32)
    shard_sizes = np.asarray(
        multihost_utils.process_allgather(jnp.asarray(sizes_loc))
    ).reshape(-1)
    n_cap = int(shard_sizes.max())
    parts = _shardwise_bcr(cols_g, lengths_g, n_cap=n_cap, L=L, mesh=mesh)
    # parts: [D, n_cap] sharded, PAD(7) past each shard's true size — exactly
    # the packed layout the merge impl takes
    n = int(shard_sizes.sum())
    blk = -(-n // D)
    wide = n >= 2**31
    with jax.enable_x64(wide):
        merged = _sharded_merge_impl(
            parts, jnp.asarray(shard_sizes),
            n=n, blk=blk, d=D, bmax=n_cap, mesh=mesh, wide=wide,
        )
    out = np.asarray(
        multihost_utils.process_allgather(merged, tiled=True)
    ).reshape(-1)[:n]
    assert out.size == n
    return out.astype(np.uint8)


def build_from_fastx_distributed(filenames, sorted_strings: bool = True):
    """The ``msbwt2-build --distributed`` flow: distributed init, per-process
    ingestion of a record stripe, global build+merge, result on process 0.

    Returns ``(decoded_bwt, is_process_zero)``; non-zero processes get the
    BWT too but should skip writing output.
    """
    import jax

    from msbwt_jax.ops.alphabet import convert_stoi
    from msbwt_jax.ops.bcr import encode_reads
    from msbwt_jax.utils.fastx import parse_fastx
    from msbwt_jax.utils.native import parse_fastx_native

    init_distributed()
    if not sorted_strings:
        raise ValueError(
            "--distributed implies lexicographic (sorted) construction: the "
            "distributed merge canonicalizes order (chronological order is "
            "not preserved across processes)"
        )
    seqs: list = []
    for filename in filenames:
        parsed = parse_fastx_native(filename)
        if parsed is None:
            parsed = [convert_stoi(s) for s in parse_fastx(filename)]
        seqs.extend(parsed)
    sl = process_read_slice(len(seqs))
    logger.info(
        "process %d/%d: records [%d, %d) of %d",
        jax.process_index(), jax.process_count(), sl.start, sl.stop, len(seqs),
    )
    reads, lengths = encode_reads(seqs[sl])
    decoded = build_msbwt_multihost(reads, lengths)
    return decoded, jax.process_index() == 0
