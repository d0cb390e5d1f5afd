"""North-star benchmark: batched k-mer count queries/s on one chip.

Dataset: 10,000 simulated 100bp reads (seeded) — the BASELINE.json
"10k simulated reads" config. The flagship op is batched ``count_kmer``
backward search over the device occurrence index; the secondary metric is
BWT construction throughput (Mbases/s) through the batched BCR builder.

``vs_baseline`` compares against a sequential host implementation of the
reference's query loop (the reference publishes no numbers and Rust is not
available here; ``csrc/msbwt_baseline.cpp`` is a C++ implementation of the
reference's algorithms, measured in the same run).

Everything runs in this one process (a second JAX process would find the
card's memory already reserved). Prints exactly ONE JSON line on stdout,
naming the device it ran on.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _compile_counter() -> dict:
    """Count XLA backend compilations in this process; the count is
    recorded in the bench JSON."""
    import jax.monitoring

    box = {"n": 0}

    def _cb(name, *a, **kw):
        if name == "/jax/core/compile/backend_compile_duration":
            box["n"] += 1

    jax.monitoring.register_event_duration_secs_listener(_cb)
    return box


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_reads(n_reads=10_000, read_len=100, seed=0xBEEF):
    rng = np.random.default_rng(seed)
    # genome-derived reads so k-mer queries hit real repeat structure
    genome = rng.integers(1, 6, size=200_000).astype(np.uint8)
    starts = rng.integers(0, genome.size - read_len, n_reads)
    reads = np.stack([genome[s : s + read_len] for s in starts])
    lengths = np.full(n_reads, read_len, dtype=np.int32)
    return reads, lengths


def make_queries(reads, n_queries=1_000_000, k=21, seed=0xFACE):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, reads.shape[0], n_queries)
    offs = rng.integers(0, reads.shape[1] - k + 1, n_queries)
    return reads[rows[:, None], offs[:, None] + np.arange(k)[None, :]]


def run_large(reps: int = 3) -> dict:
    """E. coli-scale certification: 5M x 100bp reads (505M symbols) from a
    4.6M-base genome. Build+index is median-of-``reps`` (min/max reported
    so run-to-run spread stays visible); the pair/cache derivations and the
    1M x 21-mer query batch follow. Query throughput is reported both
    device-side (the rate a device-resident pipeline sees) and including
    the full result transfer to the host."""
    if os.environ.get("MSBWT_BENCH_FAKE_LARGE"):
        # test hook: lets the CPU smoke exercise the large leg's merge into
        # the result line without a 505M build
        return {"query_qps_device": 12345, "vs_baseline_native": 1.0,
                "fake": True}
    import jax
    import jax.numpy as jnp

    from msbwt_jax.ops.bcr import build_msbwt_with_index
    from msbwt_jax.ops.pair_rank import (
        _count_kmers_pair_impl,
        build_pair_index,
    )
    from msbwt_jax.ops.rank import build_kmer_cache

    # what a plain bf16 matmul and a large copy reach on this card, recorded
    # beside the build and query numbers (utils.profiling.session_health)
    from msbwt_jax.utils.profiling import session_health

    compile_box = _compile_counter()
    health = session_health()
    log(f"[large] device ceilings: {health}")

    N, L, K, B = 5_000_000, 100, 21, 1_000_000
    rng = np.random.default_rng(0xEC011)
    genome = rng.integers(1, 6, size=4_600_000, dtype=np.uint8)
    starts = rng.integers(0, genome.size - L, N)
    reads = genome[starts[:, None] + np.arange(L)[None, :]]
    lengths = np.full(N, L, np.int32)
    n_bases = int(lengths.sum())

    t0 = time.perf_counter()
    idx, packed = build_msbwt_with_index(reads, lengths)
    jax.block_until_ready((idx.bwt, packed.table))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        del idx, packed
        t0 = time.perf_counter()
        idx, packed = build_msbwt_with_index(reads, lengths)
        jax.block_until_ready((idx.bwt, packed.table))
        times.append(time.perf_counter() - t0)
    ts = sorted(times)
    med = ts[len(ts) // 2]
    log(f"[large] build+index: median {med:.1f}s (min {ts[0]:.1f} max "
        f"{ts[-1]:.1f}; first incl compile {compile_s:.0f}s) -> "
        f"{n_bases / med / 1e6:.1f} Mbases/s")

    t0 = time.perf_counter()
    pidx = build_pair_index(idx)
    jax.block_until_ready(pidx.table2)
    pair_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    pidx = build_pair_index(idx)
    jax.block_until_ready(pidx.table2)
    pair_s = time.perf_counter() - t0
    log(f"[large] pair index: {pair_s:.1f}s steady ({pair_first:.1f} incl "
        "compile)")

    t0 = time.perf_counter()
    cache = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 8)
    jax.block_until_ready(cache)
    cache_s = time.perf_counter() - t0

    rows = rng.integers(0, N, B)
    offs = rng.integers(0, L - K + 1, B)
    kmers = jnp.asarray(reads[rows[:, None], offs[:, None] + np.arange(K)[None, :]])
    qlens = jnp.full(B, K, jnp.int32)

    def run():
        return _count_kmers_pair_impl(
            pidx.table2, pidx.starts, pidx.dmat, pidx.n, kmers, qlens,
            cache=cache, cache_k=8,
        )

    out = jax.block_until_ready(run())
    qreps = 3
    t0 = time.perf_counter()
    for _ in range(qreps):
        out = run()
    jax.block_until_ready(out)
    q_dev = (time.perf_counter() - t0) / qreps
    from msbwt_jax.ops.rank import fetch_counts

    t0 = time.perf_counter()
    counts = fetch_counts(run())  # u16 compact copy when counts allow
    q_full = time.perf_counter() - t0
    log(f"[large] queries: {B / q_dev / 1e6:.2f}M q/s device "
        f"({B / q_full / 1e6:.2f}M incl result copy); mean count "
        f"{counts.mean():.1f}")

    # deep-cache ladder: rounds per 21-mer = ceil((21 - cache_k) / 2), so
    # 6^9 (80 MB, ~1 s) already hits the 6-round count a 6^10 cache pays
    # 484 MB / ~8 s for, and 6^11 (2.9 GB) buys the 5-round count. Each
    # tier is guarded — an OOM or compile failure drops that tier only.
    deep = {}
    best_q, best_ck = q_dev, 8
    for ck in (9, 11):
        try:
            t0 = time.perf_counter()
            dcache = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, ck)
            jax.block_until_ready(dcache)
            dbuild = time.perf_counter() - t0

            def rund():
                return _count_kmers_pair_impl(
                    pidx.table2, pidx.starts, pidx.dmat, pidx.n, kmers, qlens,
                    cache=dcache, cache_k=ck,
                )

            out = jax.block_until_ready(rund())
            t0 = time.perf_counter()
            for _ in range(qreps):
                out = rund()
            jax.block_until_ready(out)
            qd = (time.perf_counter() - t0) / qreps
            log(f"[large] 6^{ck} cache: build {dbuild:.1f}s, queries "
                f"{B / qd / 1e6:.2f}M q/s device")
            deep[f"cache{ck}_seconds"] = round(dbuild, 2)
            deep[f"query_qps_device_cache{ck}"] = round(B / qd)
            if qd < best_q:
                best_q, best_ck = qd, ck
            del dcache
        except Exception as e:
            log(f"[large] 6^{ck} cache failed: {type(e).__name__}: {e}")
            deep[f"cache{ck}_error"] = f"{type(e).__name__}"

    # host RLE copy of the built BWT for the native baseline. Guarded: needs
    # a ~0.5 GB host copy.
    rle = None
    rle_s = 0.0
    try:
        from msbwt_jax.ops.rle import bytes_from_runs, runs_from_symbols

        t0 = time.perf_counter()
        rsyms, rcounts = runs_from_symbols(np.asarray(idx.bwt))
        rle = bytes_from_runs(rsyms, rcounts)
        del rsyms, rcounts
        rle_s = time.perf_counter() - t0
    except Exception as e:
        log(f"[large] host RLE encode failed: {type(e).__name__}: {e}")

    # at-scale native baseline: the reference's sequential query loop (C++,
    # csrc/msbwt_baseline.cpp) against the SAME 505M index, so the headline's
    # vs_baseline is apples-to-apples.
    base = {}
    try:
        if rle is None:
            raise RuntimeError("no host RLE copy")
        from msbwt_jax.utils.native import baseline_count_kmers_native

        nq = 20_000
        sample = np.asarray(kmers[:nq])
        # best-of-5: the minimum is the contention-free estimate; record
        # loadavg for attribution
        load_1m = os.getloadavg()[0]
        base_s, bcounts = None, None
        for _ in range(5):
            t0 = time.perf_counter()
            bcounts = baseline_count_kmers_native(rle, sample, threads=1)
            dt = time.perf_counter() - t0
            if bcounts is None:
                break
            base_s = dt if base_s is None else min(base_s, dt)
        if bcounts is not None:
            assert bcounts.tolist() == counts[:nq].tolist(), \
                "505M device/baseline count mismatch"
            base_qps = nq / base_s
            base = {
                "baseline_query_qps": round(base_qps),
                "baseline_query_reps": 5,
                "baseline_load_1m": round(load_1m, 2),
                "vs_baseline_native": round((B / best_q) / base_qps, 2),
            }
            log(f"[large] native baseline: {base_qps:,.0f} q/s ({nq} queries "
                f"x5 best; exact match; host RLE {rle_s:.1f}s; load "
                f"{load_1m:.2f}) -> device is "
                f"{base['vs_baseline_native']}x")
    except AssertionError:
        # a device/baseline COUNT MISMATCH is a correctness signal, not a
        # baseline hiccup — fail the whole bench loudly
        raise
    except Exception as e:
        log(f"[large] native baseline failed: {type(e).__name__}: {e}")
        base = {"baseline_error": f"{type(e).__name__}"}
    # fraction-of-light accounting: bytes-touched rooflines at the device's
    # published HBM peak (utils.profiling.PEAKS) — build is a
    # sequential-stream workload; queries are random-gather bound, so their
    # fraction sits well below 1 (see pair_query_roofline docstring).
    from msbwt_jax.ops.pair_rank import _row_lanes
    from msbwt_jax.utils.profiling import (
        build_roofline,
        device_peaks,
        pair_query_roofline,
    )

    build_fol = build_roofline(idx.n, L, med).fraction_of_light
    query_fol = pair_query_roofline(
        B, K, best_q, cache_k=best_ck, row_bytes=_row_lanes() * 4
    ).fraction_of_light
    hbm = device_peaks()["hbm_bytes_per_s"]
    log(f"[large] fraction of light: build {build_fol:.3f}, "
        f"query {query_fol:.3f} (cache_k={best_ck}; HBM peak "
        f"{hbm / 1e9:.0f} GB/s)")
    n_sym = int(idx.n)

    return {
        **base,
        "bwt_symbols": n_sym,
        **health,
        "build_fol": round(build_fol, 4),
        "query_fol": round(query_fol, 4),
        "fol_note": ("bytes-touched rooflines at the device's published HBM "
                     "peak; query is random-gather bound (see "
                     "utils.profiling.pair_query_roofline)"),
        "build_index_seconds_median": round(med, 2),
        "build_index_seconds_min": round(ts[0], 2),
        "build_index_seconds_max": round(ts[-1], 2),
        "build_index_reps": reps,
        "build_mbases_per_s": round(n_bases / med / 1e6, 2),
        "pair_index_seconds": round(pair_s, 2),
        "cache_seconds": round(cache_s, 2),
        "query_qps_device": round(B / best_q),
        "query_qps_device_cache8": round(B / q_dev),
        **deep,
        "query_qps_with_result_copy": round(B / q_full),
        "query_batch": B,
        "k": K,
        "backend_compiles": compile_box["n"],
        "pipeline_seconds_steady": round(med + pair_s + cache_s + q_dev, 2),
    }


def main():
    import jax

    from msbwt_jax.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    compile_box = _compile_counter()
    import jax.numpy as jnp

    from msbwt_jax.ops.bcr import build_msbwt
    from msbwt_jax.ops.packed_rank import _count_kmers_packed_impl, pack_index
    from msbwt_jax.ops.rank import build_occ_index

    # --tiny: a minutes-scale CPU smoke that exercises EVERY line of main()
    # through emit() — exists because round 3's bench measured everything and
    # then crashed at the emit step (NameError) with no test covering it.
    tiny = "--tiny" in sys.argv

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"device: {device}")

    reads, lengths = make_reads(n_reads=200 if tiny else 10_000)
    n_bases = int(lengths.sum())

    # --- build (secondary metric) ---
    t0 = time.perf_counter()
    decoded = jax.block_until_ready(
        build_msbwt(reads, lengths, device_out=True))
    build_compile_s = time.perf_counter() - t0
    build_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        decoded = jax.block_until_ready(
            build_msbwt(reads, lengths, device_out=True))
        build_s = min(build_s, time.perf_counter() - t0)
    build_mbases_s = n_bases / build_s / 1e6
    log(f"build: {build_s:.3f}s steady ({build_compile_s:.1f}s incl compile) "
        f"-> {build_mbases_s:.2f} Mbases/s, BWT size {decoded.size}")

    index = build_occ_index(jnp.asarray(decoded))
    decoded = np.asarray(decoded)  # host copy for the RLE/golden host paths

    # secondary build config: 100k reads (10.1M symbols) — a scaling point
    build100k_mbases_s = None
    if not tiny:
        reads2, lengths2 = make_reads(n_reads=100_000, seed=0xF00D)
        jax.block_until_ready(build_msbwt(reads2, lengths2, device_out=True))
        t0 = time.perf_counter()
        d2 = jax.block_until_ready(
            build_msbwt(reads2, lengths2, device_out=True))
        build100k_s = time.perf_counter() - t0
        build100k_mbases_s = float(lengths2.sum()) / build100k_s / 1e6
        log(f"build 100k reads: {build100k_s:.2f}s -> "
            f"{build100k_mbases_s:.1f} Mbases/s")
        del d2
    pidx = pack_index(index)

    from msbwt_jax.ops.rank import build_kmer_cache

    CACHE_K = 4 if tiny else 8
    t0 = time.perf_counter()
    cache = build_kmer_cache(index.bwt, index.occ, index.starts, index.n, CACHE_K)
    cache.lo.block_until_ready()
    log(f"kmer cache (6^{CACHE_K} ranges): {time.perf_counter() - t0:.2f}s")

    # --- query (north star) ---
    K = 21
    kmers = make_queries(reads, n_queries=5_000 if tiny else 1_000_000, k=K)
    B = kmers.shape[0]
    qlens = np.full(B, K, dtype=np.int32)
    kmers_d = jnp.asarray(kmers)
    qlens_d = jnp.asarray(qlens)

    def run_queries():
        return _count_kmers_packed_impl(pidx.table, pidx.starts, pidx.n,
                                        kmers_d, qlens_d, cache, CACHE_K)

    out = jax.block_until_ready(run_queries())  # compile + warmup
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run_queries()
    jax.block_until_ready(out)
    query_s = (time.perf_counter() - t0) / reps
    qps = B / query_s
    counts = np.asarray(out)
    log(f"query: {B} x {K}-mers in {query_s * 1e3:.2f} ms -> {qps:,.0f} q/s "
        f"(mean count {counts.mean():.2f}, nonzero {(counts > 0).mean():.2%})")

    # --- native CPU baseline: the reference's exact sequential algorithms in
    # C++ (csrc/msbwt_baseline.cpp — B+-tree sorted insertion + occ-bin-seeded
    # RLE-decode query loop). This is the honest Rust-class number vs_baseline
    # compares against (Rust itself is unavailable in this image).
    from msbwt_jax.ops.rle import bytes_from_runs, runs_from_symbols
    from msbwt_jax.utils.native import (
        baseline_build_native, baseline_count_kmers_native,
    )

    # Both baselines are best-of-5 (the minimum is the contention-free
    # estimate on a shared host — a median still mixes in interference),
    # with the 1-minute loadavg recorded before the runs so a disturbed
    # measurement is attributable.
    baseline_load_1m = os.getloadavg()[0]
    rle = bytes_from_runs(*runs_from_symbols(decoded))
    n_cpu = 2_000 if tiny else 200_000
    n_cpu = min(n_cpu, B)
    cpu_reps = 1 if tiny else 5
    cpu_s, cpu_counts = None, None
    for _ in range(cpu_reps):
        t0 = time.perf_counter()
        cpu_counts = baseline_count_kmers_native(rle, kmers[:n_cpu], threads=1)
        dt = time.perf_counter() - t0
        if cpu_counts is None:
            break
        cpu_s = dt if cpu_s is None else min(cpu_s, dt)
    if cpu_counts is None:  # no toolchain: slow Python fallback, tiny sample
        from msbwt_jax.models.rle_bwt import RleBWT

        host = RleBWT()
        host.load_vector(rle)
        n_cpu = 2_000
        t0 = time.perf_counter()
        cpu_counts = np.array([host.count_kmer(kmers[i]) for i in range(n_cpu)])
        cpu_s = time.perf_counter() - t0
        baseline_kind = "python-fallback"
    else:
        baseline_kind = "native-cpp-1thread"
    cpu_qps = n_cpu / cpu_s
    assert cpu_counts.tolist() == counts[:n_cpu].tolist(), \
        "device/baseline count mismatch"
    log(f"native baseline ({baseline_kind}): {cpu_qps:,.0f} q/s "
        f"({n_cpu} queries, best of {cpu_reps}; load {baseline_load_1m:.2f})")

    # baseline build throughput on the same 10k-read config (best-of-N, same
    # rationale); rows sliced to true lengths — padded tails would corrupt it
    ref_rows = [reads[i, : lengths[i]] for i in range(reads.shape[0])]
    base_build_s, base_dec = None, None
    for _ in range(cpu_reps):
        t0 = time.perf_counter()
        base_dec = baseline_build_native(ref_rows, sorted_insert=True)
        dt = time.perf_counter() - t0
        if base_dec is None:
            break
        base_build_s = dt if base_build_s is None else min(base_build_s, dt)
    base_build_mbases = (
        n_bases / base_build_s / 1e6 if base_dec is not None else None
    )
    if base_dec is not None:
        assert np.array_equal(base_dec, decoded), "baseline/device build mismatch"
        log(f"native baseline build: {base_build_s:.2f}s "
            f"-> {base_build_mbases:.2f} Mbases/s (exact match, "
            f"best of {cpu_reps})")

    # --- at-scale certification (E. coli 505M config) — the production
    # numbers; guarded so a large-scale hiccup cannot sink the whole bench
    large = {}
    run_large_leg = "--skip-large" not in sys.argv and (
        not tiny or bool(os.environ.get("MSBWT_BENCH_FAKE_LARGE"))
    )
    if run_large_leg:
        try:
            large = run_large(reps=3)
        except AssertionError:
            raise  # a count mismatch is a correctness failure, not a number
        except Exception as e:
            log(f"large config failed: {type(e).__name__}: {e}")
            large = {"error": f"{type(e).__name__}: {e}"}

    # Headline = the production figure (505M-symbol E. coli index, device-side
    # q/s); the toy config stays in extra. Falls back to the toy number only
    # when the large pass was skipped or failed.
    metric = ("kmer count queries/s/chip, device-side "
              "(1M x 21-mers vs 505M-symbol E. coli index)")
    value = large.get("query_qps_device")
    vs_baseline = large.get("vs_baseline_native")
    vs_baseline_note = None
    if value is None:
        metric = (f"kmer count queries/s/chip ({B} x 21-mers, "
                  f"{reads.shape[0]} x 100bp reads)")
        value = round(qps)
        vs_baseline = round(qps / cpu_qps, 2)
    elif vs_baseline is None:
        # the 505M leg succeeded but its native-baseline sub-step failed:
        # don't ship a null ratio — fall back to the toy-config ratio and
        # say so
        vs_baseline = round(qps / cpu_qps, 2)
        vs_baseline_note = ("505M native-baseline leg failed "
                            f"({large.get('baseline_error')}); vs_baseline "
                            "is the TOY-config ratio (conservative)")
    emit({
        "metric": metric,
        "value": value,
        "unit": "queries/s",
        "vs_baseline": vs_baseline,
        "device": device,
        "extra": {
            "ecoli_505M": large,
            **({"vs_baseline_note": vs_baseline_note}
               if vs_baseline_note else {}),
            "toy_query_qps": round(qps),
            "toy_vs_baseline": round(qps / cpu_qps, 2),
            # active perf-lever env knobs, so a recorded number can always
            # be traced back to the exact kernel configuration it measured
            "knobs": {
                k: v for k, v in os.environ.items()
                if k.startswith("MSBWT_")
            } or None,
            "build_mbases_per_s": round(build_mbases_s, 3),
            "build_seconds": round(build_s, 3),
            "build_100k_reads_mbases_per_s": (
                round(build100k_mbases_s, 3) if build100k_mbases_s else None
            ),
            "build_vs_baseline": (
                round(build_mbases_s / base_build_mbases, 2)
                if base_build_mbases else None
            ),
            "baseline_query_qps": round(cpu_qps),
            "baseline_reps": cpu_reps,
            "baseline_load_1m": round(baseline_load_1m, 2),
            "baseline_nproc": os.cpu_count(),
            "baseline_build_mbases_per_s": (
                round(base_build_mbases, 3) if base_build_mbases else None
            ),
            "bwt_symbols": int(decoded.size),
            "query_batch": B,
            "k": K,
            "backend_compiles": compile_box["n"],
            "baseline_note": "C++ implementation of the reference's exact "
                             "sequential query loop and B+-tree builder, "
                             "single-threaded (csrc/msbwt_baseline.cpp)",
        },
    })


if __name__ == "__main__":
    main()
