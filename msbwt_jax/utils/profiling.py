"""Tracing & roofline accounting (SURVEY.md §5 — the reference ships only
criterion microbenchmarks; here that is jax.profiler traces plus per-kernel
roofline math).

* ``trace(dir)`` — context manager around ``jax.profiler`` for capturing a
  device trace of any build/query region (viewable in XProf/TensorBoard).
* ``annotate(name)`` — named trace region.
* ``timeit(fn, *args)`` — steady-state timing with compile warmup and
  ``block_until_ready`` fencing; used by the benchmark suite.
* ``device_peaks(kind)`` — published peak rates of a device, keyed by
  ``device_kind``.
* ``query_roofline`` / ``build_roofline`` — bytes-touched models giving the
  speed-of-light time for the two hot paths on a given device, so measured
  numbers can be reported as a fraction of light.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import jax

# Published peaks per device_kind (NVIDIA H100 SXM data sheet: 3.35 TB/s
# HBM3, 989 TFLOP/s dense bf16, at the full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "bf16_flops_per_s": 989e12},
}


def device_peaks(kind: str | None = None) -> dict:
    """Peak rates of ``kind`` (default: the first JAX device's
    ``device_kind``). A device missing from :data:`PEAKS` is an error."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(f"no published peaks for device kind {kind!r}; "
                         f"known: {sorted(PEAKS)}") from None


def _hbm_bw(hbm_bw: float | None) -> float:
    return device_peaks()["hbm_bytes_per_s"] if hbm_bw is None else hbm_bw


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler device trace into ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region inside an active trace."""
    return jax.profiler.TraceAnnotation(name)


def timeit(fn, *args, reps: int = 5, warmup: int = 1) -> float:
    """Steady-state seconds per call (mean over reps after warmup)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def session_health(mm_n: int = 8192, copy_mwords: int = 512) -> dict:
    """What a large plain bf16 matrix product (``mm_n`` square, chained 8
    times) and a large copy (``copy_mwords`` Mi int32 words, 2 GiB at the
    default) reach on this device — the practical ceilings a kernel's
    share is read against. The size arguments let CPU tests run it small."""
    import jax.numpy as jnp

    a = jax.jit(lambda: jnp.ones((mm_n, mm_n), jnp.bfloat16))()

    @jax.jit
    def mm(a):
        def body(i, acc):
            return jnp.dot(acc, a, preferred_element_type=jnp.bfloat16) * 0.5
        return jax.lax.fori_loop(0, 8, body, a)

    jax.block_until_ready(mm(a))
    t0 = time.perf_counter()
    jax.block_until_ready(mm(a))
    mm_tflops = 8 * 2 * mm_n**3 / (time.perf_counter() - t0) / 1e12

    big = jax.jit(lambda: jnp.ones(copy_mwords * 1024 * 1024, jnp.int32))()
    copy = jax.jit(jnp.copy)
    jax.block_until_ready(copy(big))
    t0 = time.perf_counter()
    jax.block_until_ready(copy(big))
    copy_gbps = 2 * big.size * 4 / (time.perf_counter() - t0) / 1e9
    del a, big
    return {
        "matmul_tflops_bf16": mm_tflops,
        "copy_gbps": copy_gbps,
    }


@dataclass
class Roofline:
    bytes_touched: int
    seconds_at_light: float
    measured_seconds: float

    @property
    def fraction_of_light(self) -> float:
        return self.seconds_at_light / max(self.measured_seconds, 1e-12)


def query_roofline(n_queries: int, k: int, measured_seconds: float,
                   hbm_bw: float | None = None, cache_k: int = 0) -> Roofline:
    """Bytes model for batched count_kmer on the packed index: per LF step,
    two ranks, each ONE 128-byte packed row gather (ops.packed_rank); a
    prefix cache skips the first ``cache_k`` steps.

    >>> r = query_roofline(1_000_000, k=21, measured_seconds=0.1,
    ...                    hbm_bw=800e9)
    >>> r.bytes_touched            # 21 steps x 2 ranks x 128 B per query
    5376000000
    >>> 0 < r.fraction_of_light < 1
    True
    """
    steps = max(k - cache_k, 0)
    bytes_touched = n_queries * (steps * 2 * 128 + (8 if cache_k else 0))
    return Roofline(bytes_touched, bytes_touched / _hbm_bw(hbm_bw),
                    measured_seconds)


def pair_query_roofline(n_queries: int, k: int, measured_seconds: float,
                        cache_k: int = 0, row_bytes: int = 240,
                        hbm_bw: float | None = None) -> Roofline:
    """Bytes model for batched count_kmer on the 2-step PAIR index
    (ops.pair_rank): each round consumes TWO pattern symbols with two row
    gathers (both range ends), plus one single-symbol round for an odd
    tail — i.e. ``ceil((k - cache_k) / 2)`` rounds x 2 gathers x
    ``row_bytes`` (240 B compact rows by default; 512 B legacy). A prefix
    cache seeds the first ``cache_k`` symbols with one 8-byte lookup.

    Queries at this scale are random-gather bound, not stream-bandwidth
    bound, so fractions of light well below 1 are expected and the model
    deliberately uses the spec bandwidth — the gap to 1.0 is the price of
    random access.

    >>> r = pair_query_roofline(1_000_000, k=21, measured_seconds=0.1,
    ...                         cache_k=9, hbm_bw=800e9)
    >>> r.bytes_touched        # ceil(12/2)=6 rounds x 2 x 240 B + 8 B
    2888000000
    >>> 0 < r.fraction_of_light < 1
    True
    """
    rounds = -(-max(k - cache_k, 0) // 2)
    bytes_touched = n_queries * (rounds * 2 * row_bytes + (8 if cache_k else 0))
    return Roofline(bytes_touched, bytes_touched / _hbm_bw(hbm_bw),
                    measured_seconds)


def build_roofline(n_symbols: int, max_read_len: int, measured_seconds: float,
                   hbm_bw: float | None = None) -> Roofline:
    """Bytes model for the fused BCR engine (``ops.merge_insert``): each of
    ~max_read_len stages reads the int32 phys buffer (4 B/symbol), writes
    the merged one (4 B) and its packed rank table (2 B), and writes then
    reads the int8 insertion map (2 B) — 12 B per symbol of capacity.

    >>> build_roofline(1_000_000, 100, 1.0, hbm_bw=1e12).bytes_touched
    1212000000
    """
    bytes_touched = (max_read_len + 1) * n_symbols * (4 + 4 + 2 + 2)
    return Roofline(bytes_touched, bytes_touched / _hbm_bw(hbm_bw),
                    measured_seconds)
