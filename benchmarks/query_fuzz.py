"""Randomized cross-engine query fuzz: every query engine must agree.

For random read collections and random (ragged-length, $-containing)
k-mer batches, checks single-step occ rank == packed rank == packed+cache
== pair == pair+cache, and that locate_kmers is count- and
content-consistent with the counts. Runs on CPU (pass --cpu) or on a GPU
(PAIR_FAST/PAIR_ROW60 lanes alternate per trial).

Usage: python benchmarks/query_fuzz.py [--cpu] [trials]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

from msbwt_jax.utils.jaxcache import enable_persistent_cache

enable_persistent_cache()

from msbwt_jax.ops.bcr import build_msbwt, encode_reads, sort_reads
from msbwt_jax.ops.extract import locate_kmers
from msbwt_jax.ops.packed_rank import count_kmers_packed, pack_index
from msbwt_jax.ops.pair_rank import build_pair_index, count_kmers_pair
from msbwt_jax.ops.rank import (
    build_kmer_cache,
    build_occ_index,
    count_kmers,
)

trials = next((int(a) for a in sys.argv[1:] if a.isdigit()), 6)
fails = 0
for trial in range(trials):
    rng = np.random.default_rng(7000 + trial)
    if trial % 2 == 1:
        os.environ["MSBWT_PAIR_FAST"] = "1"
        os.environ["MSBWT_PAIR_ROW60"] = "1"
    else:
        os.environ.pop("MSBWT_PAIR_FAST", None)
        os.environ.pop("MSBWT_PAIR_ROW60", None)
    nr = int(rng.integers(20, 150))
    reads_l = [rng.integers(1, 6, int(rng.integers(3, 40))).astype(np.uint8)
               for _ in range(nr)]
    reads, lens = encode_reads(reads_l)
    dec = build_msbwt(reads, lens)
    idx = build_occ_index(dec)
    pidx = pack_index(idx)
    pr = build_pair_index(idx)
    K = int(rng.integers(2, 8))
    B = 120
    kmers = rng.integers(0, 6, size=(B, K)).astype(np.uint8)
    qlens = rng.integers(1, K + 1, B).astype(np.int32)
    a = np.asarray(count_kmers(idx, kmers, qlens))
    b = np.asarray(count_kmers_packed(pidx, kmers, qlens))
    cache = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 2)
    c = np.asarray(count_kmers_packed(pidx, kmers, qlens,
                                      cache=cache, cache_k=2))
    d = np.asarray(count_kmers_pair(pr, kmers, qlens))
    e = np.asarray(count_kmers_pair(pr, kmers, qlens,
                                    cache=cache, cache_k=2))
    ok = all(np.array_equal(a, x) for x in (b, c, d, e))
    nz = np.all(kmers > 0, axis=1) & (qlens == K)
    q, r, o = locate_kmers(idx, kmers[nz], nr)
    ok = ok and np.array_equal(
        np.bincount(q, minlength=int(nz.sum())), a[nz])
    srt, _sl = sort_reads(reads, lens)
    for qq, rr, oo in list(zip(q.tolist(), r.tolist(), o.tolist()))[:50]:
        if not np.array_equal(srt[rr, oo:oo + K], kmers[nz][qq]):
            ok = False
            break
    print(f"trial {trial} (fast={trial % 2}): {'OK' if ok else 'FAIL'}",
          flush=True)
    fails += 0 if ok else 1
print(f"{fails} failures / {trials} trials")
sys.exit(1 if fails else 0)
