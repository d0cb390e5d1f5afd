"""Criterion-parity microbenchmark suite (fixed seeds, named benches —
mirrors the reference's benches/ds_benchmarks.rs protocol):

* ``bcr_insert_10k_symbols``  — dynamic-structure absorption of 10k symbols
  (analogue of ``rle_bplus_tree_10k_random``: 10k seeded-random
  insert_and_count, ref: ds_benchmarks.rs:60-69 — here the batched stage
  kernel does the same total insertion work).
* ``rank_batch``              — batched rank over the occ index (analogue of
  the block count/insert microbench, ref: ds_benchmarks.rs:71-84).
* ``rle_bwt_count_kmer`` / ``dyn_bwt_count_kmer`` — the reference's exact
  query protocol (ref: ds_benchmarks.rs:86-105): a 10k-copy BWT of
  "AAAAACCCCCTTTTTGGGGGACGTACGTTGCATGCA", queries ACGT + AACC, on both
  engines (scalar host loop, like the reference) plus the batched device
  path the reference has no equivalent of.

Run: ``python -m benchmarks.micro`` (add ``--json`` for machine output).
"""

from __future__ import annotations

import json
import sys

import numpy as np


def run_all() -> dict:
    import jax.numpy as jnp

    from msbwt_jax.models.dynamic import DynamicBWT
    from msbwt_jax.models.rle_bwt import RleBWT
    from msbwt_jax.ops import rank as rank_ops
    from msbwt_jax.ops.alphabet import convert_stoi
    from msbwt_jax.ops.bcr import build_msbwt, encode_reads
    from msbwt_jax.ops.rle import bytes_from_runs, runs_from_symbols
    from msbwt_jax.utils.profiling import timeit

    results = {}
    rng = np.random.default_rng(0)

    # --- bcr_insert_10k_symbols ---
    reads = rng.integers(1, 6, size=(500, 19)).astype(np.uint8)  # 10k symbols
    lengths = np.full(500, 19, dtype=np.int32)
    results["bcr_insert_10k_symbols_s"] = timeit(
        lambda: build_msbwt(reads, lengths), reps=3
    )

    # --- rank_batch ---
    decoded = build_msbwt(reads, lengths)
    index = rank_ops.build_occ_index(jnp.asarray(decoded))
    pos = jnp.asarray(rng.integers(0, decoded.size, 4096).astype(np.int32))
    sym = jnp.asarray(rng.integers(0, 6, 4096).astype(np.int32))
    import jax

    rank_jit = jax.jit(lambda s, p: rank_ops.rank(index, s, p))
    results["rank_batch_4096_s"] = timeit(rank_jit, sym, pos)

    # --- reference query protocol ---
    base = "AAAAACCCCCTTTTTGGGGGACGTACGTTGCATGCA"
    reads10k, lens10k = encode_reads([convert_stoi(base)] * 10000)
    decoded10k = build_msbwt(reads10k, lens10k)
    rle_bytes = bytes_from_runs(*runs_from_symbols(decoded10k))

    rle_bwt = RleBWT()
    rle_bwt.load_vector(rle_bytes)
    dyn_bwt = DynamicBWT()
    dyn_bwt.load_vector(rle_bytes)
    q1, q2 = convert_stoi("ACGT"), convert_stoi("AACC")
    assert rle_bwt.count_kmer(q1) == 20000 and rle_bwt.count_kmer(q2) == 10000

    import time

    def host_pair(bwt):
        t0 = time.perf_counter()
        for _ in range(50):
            bwt.count_kmer(q1)
            bwt.count_kmer(q2)
        return (time.perf_counter() - t0) / 50

    results["rle_bwt_count_kmer_s"] = host_pair(rle_bwt)
    results["dyn_bwt_count_kmer_s"] = host_pair(dyn_bwt)

    # batched device path (no reference equivalent)
    B = 100_000
    kmers = np.zeros((B, 4), dtype=np.uint8)
    kmers[::2] = q1
    kmers[1::2] = q2
    didx = rle_bwt.device_index
    kd = jnp.asarray(kmers)
    ld = jnp.asarray(np.full(B, 4, np.int32))
    results["batched_count_kmer_100k_s"] = timeit(
        lambda: rank_ops._count_kmers_impl(
            didx.bwt, didx.occ, didx.starts, didx.n, kd, ld
        )
    )
    results["batched_count_kmer_qps"] = B / results["batched_count_kmer_100k_s"]

    # packed single-gather rank (the production query layout)
    from msbwt_jax.ops.packed_rank import _count_kmers_packed_impl, pack_index

    pidx = pack_index(didx)
    results["packed_count_kmer_100k_s"] = timeit(
        lambda: _count_kmers_packed_impl(pidx.table, pidx.starts, pidx.n, kd, ld)
    )
    results["packed_count_kmer_qps"] = B / results["packed_count_kmer_100k_s"]

    # merge-insert pass of the fused engine (the BCR stage rebuild),
    # 1M-symbol buffer; timed on accelerators only
    from msbwt_jax.ops import merge_insert as pm

    if jax.default_backend() != "cpu":
        n_cap = 1_000_000
        old = pm.to_phys(
            jnp.asarray(rng.integers(0, 6, n_cap).astype(np.int32)), n_cap
        )
        q = jnp.asarray(
            np.sort(rng.choice(n_cap, 10_000, replace=False)).astype(np.int32)
        )
        v = jnp.asarray(rng.integers(0, 6, 10_000).astype(np.int32))
        act = jnp.ones(10_000, bool)

        @jax.jit
        def merge_loop(old, q, v, act):
            def body(i, cur):
                new, _tab, _ = pm.merge_insert_phys(cur, q, v, act)
                return new
            return jax.lax.fori_loop(0, 10, body, old)[0, :1]

        r = merge_loop(old, q, v, act)
        int(np.asarray(r)[0])
        t0 = time.perf_counter()
        r = merge_loop(old, q, v, act)
        int(np.asarray(r)[0])
        results["merge_pass_1m_s"] = (time.perf_counter() - t0) / 10
    return results


def main():
    results = run_all()
    if "--json" in sys.argv:
        print(json.dumps(results))
    else:
        for k, v in results.items():
            print(f"{k:36s} {v:,.6f}")


if __name__ == "__main__":
    main()
