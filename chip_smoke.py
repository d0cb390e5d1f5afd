#!/usr/bin/env python3
"""Smoke run of the build-and-query path on one GPU.

Drives what users of ``msbwt2`` run, through the normal entry points, at
the E. coli-scale deployment of BASELINE.json config 4: 5,000,000 reads of
100 bp sampled from a 4.6 Mb genome generated from ``--seed`` (505M BWT
symbols).

Phases, in one process on one card:

1. ``main_path``: write the reads as FASTQ, run ``msbwt2-build -o out.npy
   reads.fq`` (``msbwt_jax.cli.build.main``), load the index with
   ``RleBWT.load_numpy_file`` and answer a batch of 21-mers with
   ``count_kmers``. Counts must equal direct counts over the reads on the
   host and the native reference query loop.
2. ``golden`` and ``oracle``: the golden two_string build is byte-identical;
   a ~2k variable-length read collection built sorted, unsorted and as an
   extend equals ``utils.oracle.naive_bwt``.
3. ``merge_pass`` and ``engines``: one merge-insert pass at full capacity
   beside a device copy of the same buffer, then both build engines at full
   size, checked equal to each other and to the CLI's output.

``--multi`` runs only the four-card path: the partitioned build with psum
counts and the sharded merge (dense and ragged), each compared with the
one-card build of the same reads.

Every reported time sits beside the card's name and power limit. Any failed
check raises, and the script exits non-zero without a result line; it also
refuses to run when JAX finds no GPU. The last line of stdout is one JSON
object naming the device.

Usage: python chip_smoke.py [--multi] [--seed S] [--reads N] [--queries Q]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GENOME_BASES = 4_600_000
READ_LEN = 100
K = 21
DNA = np.array([1, 2, 3, 5], np.uint8)  # A C G T in the symbol alphabet


class Smoke:
    """Prints each measurement beside the card it was taken on."""

    def __init__(self, card: str):
        self.card = card

    def time(self, name: str, seconds: float, extra: str = "") -> None:
        print(f"{name}: {seconds:.6f} s{extra}  [{self.card}]", flush=True)

    def value(self, name: str, value, unit: str) -> None:
        print(f"{name}: {value} {unit}  [{self.card}]", flush=True)

    def ok(self, name: str, detail: str) -> None:
        print(f"PASS {name}: {detail}", flush=True)


def card_line() -> str:
    """``name, power.limit`` of the card(s), as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return " | ".join(line.strip() for line in out.splitlines())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def peak_bytes():
    """``peak_bytes_in_use`` of the first device, or "not reported"."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def make_reads(seed: int, n_reads: int, genome_bases: int = GENOME_BASES,
               read_len: int = READ_LEN) -> np.ndarray:
    """``[n_reads, read_len]`` reads sampled uniformly from a random ACGT
    genome, both drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    genome = DNA[rng.integers(0, 4, genome_bases)]
    starts = rng.integers(0, genome_bases - read_len + 1, n_reads)
    windows = np.lib.stride_tricks.sliding_window_view(genome, read_len)
    return windows[starts]


def make_kmers(seed: int, reads: np.ndarray, n_queries: int,
               absent_share: float = 0.1) -> np.ndarray:
    """``[n_queries, K]`` 21-mers: most sampled from the reads, the rest
    random ACGT (almost all absent), shuffled together."""
    rng = np.random.default_rng(seed + 1)
    n_abs = int(n_queries * absent_share)
    n_pre = n_queries - n_abs
    rows = rng.integers(0, reads.shape[0], n_pre)
    offs = rng.integers(0, reads.shape[1] - K + 1, n_pre)
    present = np.lib.stride_tricks.sliding_window_view(reads, K, axis=1)[
        rows, offs]
    absent = DNA[rng.integers(0, 4, (n_abs, K))]
    kmers = np.concatenate([present, absent])
    return np.ascontiguousarray(kmers[rng.permutation(n_queries)])


def write_fastq(path: str, reads: np.ndarray, chunk: int = 500_000) -> None:
    """Fixed-width FASTQ records ``@r<9 digits>``, quality all 'I'."""
    letters = np.frombuffer(b"$ACGNT", np.uint8)
    n, L = reads.shape
    rec = 12 + L + 1 + 2 + L + 1
    with open(path, "wb") as f:
        for a in range(0, n, chunk):
            r = reads[a : a + chunk]
            ids = np.arange(a, a + r.shape[0])
            buf = np.empty((r.shape[0], rec), np.uint8)
            buf[:, 0] = ord("@")
            buf[:, 1] = ord("r")
            for d in range(9):
                buf[:, 2 + d] = 48 + (ids // 10 ** (8 - d)) % 10
            buf[:, 11] = 10
            buf[:, 12 : 12 + L] = letters[r]
            buf[:, 12 + L] = 10
            buf[:, 13 + L] = ord("+")
            buf[:, 14 + L] = 10
            buf[:, 15 + L : 15 + 2 * L] = ord("I")
            buf[:, -1] = 10
            f.write(buf.tobytes())


def host_counts(reads: np.ndarray, kmers: np.ndarray,
                chunk: int = 100_000) -> np.ndarray:
    """Occurrences of each k-mer in the reads, counted directly over every
    read window (3-bit codes; no BWT involved)."""
    k = kmers.shape[1]
    kc = np.zeros(kmers.shape[0], np.int64)
    for j in range(k):
        kc = (kc << 3) | kmers[:, j].astype(np.int64)
    uniq, inv = np.unique(kc, return_inverse=True)
    counts = np.zeros(uniq.size, np.int64)
    w = reads.shape[1] - k + 1
    for a in range(0, reads.shape[0], chunk):
        r = reads[a : a + chunk].astype(np.int64)
        code = np.zeros((r.shape[0], w), np.int64)
        for j in range(k):
            code <<= 3
            code |= r[:, j : j + w]
        flat = code.ravel()
        pos = np.minimum(np.searchsorted(uniq, flat), uniq.size - 1)
        hit = uniq[pos] == flat
        counts += np.bincount(pos[hit], minlength=uniq.size)
    return counts[inv]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_main_path(smoke: Smoke, work: str, reads: np.ndarray,
                    kmers: np.ndarray, n_host: int = 2_000,
                    n_native: int = 20_000) -> str:
    """FASTQ -> msbwt2-build -> .npy -> RleBWT -> count_kmers, checked.
    Returns the path of the written index."""
    from msbwt_jax.cli.build import main as build_main
    from msbwt_jax.models.rle_bwt import RleBWT
    from msbwt_jax.utils.native import baseline_count_kmers_native
    from msbwt_jax.utils.npy import load_bwt_bytes

    fq = os.path.join(work, "reads.fq")
    npy = os.path.join(work, "comp_msbwt.npy")
    t0 = time.perf_counter()
    write_fastq(fq, reads)
    smoke.time("fastq write (host set-up)", time.perf_counter() - t0)

    n_bases = int(reads.size)
    t0 = time.perf_counter()
    rc = build_main(["-o", npy, fq])
    build_s = time.perf_counter() - t0
    check(rc == 0, f"msbwt2-build exited {rc}")
    smoke.time("msbwt2-build FASTQ -> .npy (cold, compile included)",
               build_s, f"  ({n_bases / build_s / 1e6:.3f} Mbases/s)")
    os.unlink(fq)

    bwt = RleBWT()
    t0 = time.perf_counter()
    bwt.load_numpy_file(npy)
    smoke.time("RleBWT.load_numpy_file", time.perf_counter() - t0)
    check(bwt.get_total_size() == n_bases + reads.shape[0],
          f"index holds {bwt.get_total_size()} symbols")
    smoke.value("index symbols", bwt.get_total_size(), "")

    t0 = time.perf_counter()
    first = bwt.count_kmers(kmers)
    setup_s = time.perf_counter() - t0
    smoke.time(f"count_kmers first batch of {kmers.shape[0]} (tier set-up "
               "and compile included)", setup_s)
    smoke.value("query tier", "pair" if bwt._pair_index is not None else
                ("run" if bwt._run_index is not None else "packed"),
                f"(cache 6^{bwt._cache_k})")
    t0 = time.perf_counter()
    counts = bwt.count_kmers(kmers)
    q_s = time.perf_counter() - t0
    smoke.time(f"count_kmers batch of {kmers.shape[0]}", q_s,
               f"  ({kmers.shape[0] / q_s:.1f} q/s)")
    check(np.array_equal(first, counts), "repeated batch changed counts")
    smoke.value("peak_bytes_in_use after build and query", peak_bytes(), "B")

    t0 = time.perf_counter()
    want = host_counts(reads, kmers[:n_host])
    smoke.time(f"host direct count of {n_host} k-mers (reference)",
               time.perf_counter() - t0)
    check(np.array_equal(counts[:n_host], want),
          "device counts != direct host counts")
    smoke.ok("host counts", f"{n_host} k-mers exact "
             f"({int((want == 0).sum())} absent, max count {int(want.max())})")

    rle = load_bwt_bytes(npy)
    t0 = time.perf_counter()
    native = baseline_count_kmers_native(rle, kmers[:n_native], threads=1)
    native_s = time.perf_counter() - t0
    check(native is not None, "native reference query loop unavailable")
    smoke.time(f"native reference loop, {n_native} k-mers, 1 thread",
               native_s, f"  ({n_native / native_s:.1f} q/s)")
    check(np.array_equal(counts[:n_native], native),
          "device counts != native reference loop")
    smoke.ok("native reference loop", f"{n_native} k-mers exact")
    return npy


def phase_golden(smoke: Smoke, work: str) -> None:
    from msbwt_jax.cli.build import main as build_main

    out = os.path.join(work, "two_string.npy")
    rc = build_main(["-o", out, os.path.join(REPO, "test_data",
                                              "two_string.fa")])
    check(rc == 0, f"golden msbwt2-build exited {rc}")
    with open(out, "rb") as a, open(
            os.path.join(REPO, "test_data", "two_string.npy"), "rb") as b:
        check(a.read() == b.read(), "two_string.npy is not byte-identical")
    smoke.ok("golden", "test_data/two_string.fa builds byte-identical")


def oracle_reads(seed: int, n: int = 2_000) -> list[str]:
    """Variable-length reads (1..150 bp) from a 5 kb genome: overlaps,
    shared prefixes and duplicates exercise the tie rules."""
    rng = np.random.default_rng(seed + 2)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 5_000)])
    lens = rng.integers(1, 151, n)
    starts = rng.integers(0, 5_000 - lens + 1)
    return [genome[s : s + ln] for s, ln in zip(starts, lens)]


def phase_oracle(smoke: Smoke, seed: int, n: int = 2_000) -> None:
    from msbwt_jax.models.dynamic import DynamicBWT
    from msbwt_jax.ops.alphabet import convert_itos
    from msbwt_jax.utils.oracle import naive_bwt

    strs = oracle_reads(seed, n)
    want = naive_bwt(strs)
    b = DynamicBWT()
    b.insert_strings(strs, True)
    check(convert_itos(b.to_vec()) == want, "sorted build != naive_bwt")
    # chronological insertion of lexicographically ordered input is the
    # sorted result (the reference's own unsorted test idiom)
    u = DynamicBWT()
    u.insert_strings(sorted(strs), False)
    check(convert_itos(u.to_vec()) == want, "unsorted build != naive_bwt")
    half = len(strs) // 2
    e = DynamicBWT()
    e.insert_strings(strs[:half], True)
    e.to_vec()
    e.insert_strings(strs[half:], True)
    check(convert_itos(e.to_vec()) == want, "extend build != naive_bwt")
    smoke.ok("oracle", f"{len(strs)} reads, {len(want)} symbols: sorted, "
             "unsorted and extend equal naive_bwt")


def _median_time(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2]


def phase_merge_pass(smoke: Smoke, seed: int, n_cap: int,
                     n_ins: int) -> None:
    """One merge-insert pass at capacity ``n_cap`` (``n_ins`` insertions)
    beside a device copy of the same phys buffer."""
    import jax
    import jax.numpy as jnp

    from msbwt_jax.ops import merge_insert as mi

    rng = np.random.default_rng(seed + 3)
    n_old = n_cap - n_ins
    q = jnp.asarray(np.sort(rng.choice(n_cap, n_ins, replace=False))
                    .astype(np.int32))
    v = jnp.asarray(rng.integers(0, 6, n_ins).astype(np.int32))
    act = jnp.ones(n_ins, bool)
    key = jax.random.PRNGKey(seed)

    @jax.jit
    def make_old(key):
        sym = jax.random.randint(key, (n_cap,), 0, 6, jnp.int32)
        return mi.to_phys(
            jnp.where(jnp.arange(n_cap) < n_old, sym, mi._PAD), n_cap)

    old = make_old(key)
    merge = jax.jit(mi.merge_insert_phys)
    new, table, m = merge(old, q, v, act)
    check(int(m) == n_ins, "merge pass inserted a wrong count")
    check(int(table[-1, 0]) + int(table[-1, 1]) >= 0, "table not written")
    del new, table
    merge_s = _median_time(merge, old, q, v, act)
    copy_s = _median_time(jax.jit(jnp.copy), old)
    nbytes = old.size * old.dtype.itemsize
    smoke.time(f"merge-insert pass, capacity {n_cap}, {n_ins} insertions",
               merge_s, f"  (model 12 B/symbol: "
               f"{12 * n_cap / merge_s / 1e9:.1f} GB/s)")
    smoke.time(f"device copy of the same {nbytes} B phys buffer", copy_s,
               f"  ({2 * nbytes / copy_s / 1e9:.1f} GB/s read+write)")
    smoke.value("merge pass / copy time", f"{merge_s / copy_s:.3f}", "x")
    del old


def phase_engines(smoke: Smoke, reads: np.ndarray, npy: str) -> None:
    """Both build engines through ``build_msbwt_with_index``: compile, then
    one timed warm build each; outputs equal each other and the index that
    ``msbwt2-build`` wrote to ``npy``."""
    import jax
    import jax.numpy as jnp

    from msbwt_jax.ops.bcr import ENGINES, build_msbwt_with_index
    from msbwt_jax.ops.rle import decode_symbols_device
    from msbwt_jax.utils.npy import load_bwt_bytes

    lengths = np.full(reads.shape[0], reads.shape[1], np.int32)
    n_bases = int(reads.size)
    built = {}
    for eng in ENGINES:
        t0 = time.perf_counter()
        idx, packed = build_msbwt_with_index(reads, lengths, engine=eng)
        jax.block_until_ready((idx.bwt, packed.table))
        first = time.perf_counter() - t0
        del idx, packed
        t0 = time.perf_counter()
        idx, packed = build_msbwt_with_index(reads, lengths, engine=eng)
        jax.block_until_ready((idx.bwt, packed.table))
        warm = time.perf_counter() - t0
        smoke.time(f"engine {eng}: build_msbwt_with_index, first call",
                   first)
        smoke.time(f"engine {eng}: build_msbwt_with_index, warm", warm,
                   f"  ({n_bases / warm / 1e6:.3f} Mbases/s)")
        built[eng] = (idx.bwt[: idx.n], packed.table)
        del idx, packed
    (bx, tx), (bf, tf) = built["xla"], built["fused"]
    check(bool(jnp.array_equal(bx, bf)), "engines disagree on the BWT")
    check(bool(jnp.array_equal(tx, tf)), "engines disagree on the rank table")
    dec = decode_symbols_device(load_bwt_bytes(npy), int(bx.shape[0]))
    check(bool(jnp.array_equal(dec, bx)), "engine BWT != msbwt2-build's")
    smoke.ok("engines", "xla and fused agree and equal the CLI's .npy")


def phase_multi(smoke: Smoke, reads: np.ndarray, kmers: np.ndarray) -> None:
    """Partitioned build + psum counts, and the sharded merge (dense and
    ragged), on a 4-device mesh against the one-card build."""
    import jax

    from msbwt_jax.ops.bcr import build_msbwt, sort_reads
    from msbwt_jax.ops.rank import build_occ_index, count_kmers
    from msbwt_jax.parallel.mesh import default_mesh
    from msbwt_jax.parallel.partitioned import (
        build_partitioned,
        count_kmers_partitioned,
    )
    from msbwt_jax.parallel.sharded_merge import sharded_hm_merge

    mesh = default_mesh(4)
    lengths = np.full(reads.shape[0], reads.shape[1], np.int32)
    one_dev = jax.devices()[0]
    with jax.default_device(one_dev):
        t0 = time.perf_counter()
        single = build_msbwt(reads, lengths)
        smoke.time("one-card build (reference for the mesh)",
                   time.perf_counter() - t0)
        want = count_kmers(build_occ_index(single), kmers)

    for rep in ("first call", "warm"):
        t0 = time.perf_counter()
        pidx = build_partitioned(reads, lengths, mesh=mesh)
        jax.block_until_ready(pidx.table)
        smoke.time(f"partitioned build on 4 cards, {rep}",
                   time.perf_counter() - t0)
    for rep in ("first call", "warm"):
        t0 = time.perf_counter()
        got = count_kmers_partitioned(pidx, kmers)
        smoke.time(f"partitioned psum count of {kmers.shape[0]} k-mers, "
                   f"{rep}", time.perf_counter() - t0)
    check(np.array_equal(got, want), "partitioned counts != one-card counts")
    smoke.ok("partitioned", f"{kmers.shape[0]} k-mer counts equal the "
             "one-card index")
    del pidx

    sreads, slens = sort_reads(reads, lengths)
    groups = np.array_split(np.arange(sreads.shape[0]), 4)
    with jax.default_device(one_dev):
        parts = [build_msbwt(sreads[g], slens[g]) for g in groups]
    for transport in ("dense", "ragged"):
        for rep in ("first call", "warm"):
            t0 = time.perf_counter()
            merged = sharded_hm_merge(parts, mesh=mesh, transport=transport)
            smoke.time(f"sharded merge ({transport}) on 4 cards, {rep}",
                       time.perf_counter() - t0)
        check(np.array_equal(merged, single),
              f"sharded merge ({transport}) != one-card build")
        smoke.ok(f"sharded merge ({transport})",
                 f"{merged.size} symbols equal the one-card build")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card path and its comparison")
    ap.add_argument("--seed", type=int, default=0xEC011)
    ap.add_argument("--reads", type=int, default=None,
                    help="reads to build (default 5,000,000; 1,000,000 "
                    "with --multi)")
    ap.add_argument("--queries", type=int, default=1_000_000)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r}); refusing to run", file=sys.stderr)
        return 2
    need = 4 if args.multi else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    from msbwt_jax.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    card = card_line()
    smoke = Smoke(card)
    print(f"devices: {len(devices)} x {devices[0].device_kind}", flush=True)

    n_reads = args.reads or (1_000_000 if args.multi else 5_000_000)
    t0 = time.perf_counter()
    reads = make_reads(args.seed, n_reads)
    kmers = make_kmers(args.seed, reads, args.queries)
    smoke.time(f"generate {n_reads} reads and {args.queries} k-mers (host)",
               time.perf_counter() - t0)

    if args.multi:
        phase_multi(smoke, reads, kmers)
    else:
        os.makedirs(os.path.join(REPO, ".smoke"), exist_ok=True)
        work = tempfile.mkdtemp(dir=os.path.join(REPO, ".smoke"))
        try:
            npy = phase_main_path(smoke, work, reads, kmers)
            phase_golden(smoke, work)
            phase_oracle(smoke, args.seed)
            n_sym = int(reads.size) + reads.shape[0]
            phase_merge_pass(smoke, args.seed, n_sym, reads.shape[0])
            phase_engines(smoke, reads, npy)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        smoke.value("peak_bytes_in_use at exit", peak_bytes(), "B")

    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
