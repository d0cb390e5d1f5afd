"""Gigabase-scale counting on ONE chip: 10M x 100bp reads (1.01G symbols).

Two configurations over the same read set (a chr21-class volume — the
reference's own large benchmark is ~half this, ref: README.md "NA12878"
discussion and benches/ds_benchmarks.rs):

1. **partitioned** (the pod-scaling model, ``parallel/partitioned.py``
   docstring): the reads split into two disjoint partitions; each builds
   its own 505M-symbol BWT + 2-step index; ``count_kmer`` is additive
   across partitions, so the global counts are one vector add. On several
   cards each partition lives on its own device — here the two run
   sequentially on the single chip, which measures the same per-device
   work with zero-collective scaling.
2. **direct** (guarded attempt): one 1.01G-symbol single-device build —
   inside int32; a failure (e.g. out of device memory) is reported, not
   fatal.

Run: python -m benchmarks.gigabase
Prints one JSON line per result.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from msbwt_jax.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    from msbwt_jax.ops.bcr import build_msbwt_with_index
    from msbwt_jax.ops.pair_rank import (
        _count_kmers_pair_impl,
        build_pair_index,
    )
    from msbwt_jax.ops.rank import build_kmer_cache

    log(f"device: {jax.devices()[0]}")

    if "--tiny" in sys.argv:   # CPU smoke: same flow at 1/250 scale
        N, L, K, B = 40_000, 50, 21, 10_000
        CACHE_K = 4
        genome_size = 400_000
    else:
        N, L, K, B = 10_000_000, 100, 21, 1_000_000
        CACHE_K = 9
        genome_size = 40_000_000
    P = 2                      # partitions
    rng = np.random.default_rng(0xC21)
    genome = rng.integers(1, 6, size=genome_size, dtype=np.uint8)
    starts = rng.integers(0, genome.size - L, N)
    lengths_part = np.full(N // P, L, np.int32)

    rows = rng.integers(0, N, B)
    offs = rng.integers(0, L - K + 1, B)

    def part_reads(p):
        s = starts[p * (N // P) : (p + 1) * (N // P)]
        return genome[s[:, None] + np.arange(L)[None, :]]

    kmers_np = genome[
        (starts[rows] + offs)[:, None] + np.arange(K)[None, :]
    ]
    kmers = jnp.asarray(kmers_np)
    qlens = jnp.full(B, K, jnp.int32)

    if "--direct-only" in sys.argv:
        _direct(genome, starts, N, L)
        return

    # --- 1. partitioned: P sequential per-device programs ---
    total = np.zeros(B, np.int64)
    t_all = time.perf_counter()
    per_part = []
    for p in range(P):
        reads = part_reads(p)
        t0 = time.perf_counter()
        idx, packed = build_msbwt_with_index(reads, lengths_part)
        int(np.asarray(idx.bwt[:1])[0])
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        pidx = build_pair_index(idx)
        cache = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, CACHE_K)
        int(np.asarray(pidx.table2[0, :1])[0] + np.asarray(cache.lo[:1])[0])
        t_index = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = _count_kmers_pair_impl(
            pidx.table2, pidx.starts, pidx.dmat, pidx.n, kmers, qlens,
            cache=cache, cache_k=CACHE_K,
        )
        counts = np.asarray(out)
        t_query = time.perf_counter() - t0
        total += counts
        per_part.append(
            {"symbols": int(idx.n), "build_s": round(t_build, 1),
             "index_s": round(t_index, 1), "query_s": round(t_query, 2)}
        )
        log(f"partition {p}: n={idx.n} build {t_build:.1f}s index "
            f"{t_index:.1f}s query {t_query:.2f}s mean {counts.mean():.1f}")
        del idx, packed, pidx, cache, out, reads
    t_total = time.perf_counter() - t_all
    n_syms = sum(q["symbols"] for q in per_part)
    # sanity: every queried k-mer exists in the read set (it was sampled
    # from a read), so the summed counts must all be >= 1
    assert int(total.min()) >= 1, "additivity violated: zero global count"
    print(json.dumps({
        "config": "partitioned_1G_counting",
        "partitions": P,
        "total_symbols": n_syms,
        "wall_seconds": round(t_total, 1),
        "build_mbases_per_s": round(N * L / sum(q["build_s"] for q in per_part) / 1e6, 1),
        "query_qps_total": round(B / sum(q["query_s"] for q in per_part)),
        "mean_count": round(float(total.mean()), 2),
        "per_partition": per_part,
    }), flush=True)

    # --- 2. direct 1.01G single-device build (guarded) ---
    if "--skip-direct" in sys.argv:
        return
    _direct(genome, starts, N, L)


def _direct(genome, starts, N, L):
    import numpy as np

    from msbwt_jax.ops.bcr import build_msbwt_with_index

    try:
        reads = genome[starts[:, None] + np.arange(L)[None, :]]
        lengths = np.full(N, L, np.int32)
        t0 = time.perf_counter()
        idx, packed = build_msbwt_with_index(reads, lengths)
        int(np.asarray(idx.bwt[:1])[0])
        t_build = time.perf_counter() - t0
        log(f"direct 1G build: {t_build:.1f}s, n={idx.n}")
        print(json.dumps({
            "config": "direct_1G_build",
            "total_symbols": int(idx.n),
            "build_seconds": round(t_build, 1),
            "build_mbases_per_s": round(N * L / t_build / 1e6, 1),
        }), flush=True)
    except Exception as e:
        # full error to stderr for attribution (the JSON line keeps a stub)
        log(f"direct 1G failure detail: {type(e).__name__}: {e}")
        print(json.dumps({
            "config": "direct_1G_build",
            "error": f"{type(e).__name__}: {e}"[:400],
        }), flush=True)


if __name__ == "__main__":
    main()
