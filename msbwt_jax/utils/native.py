"""ctypes bindings to the native host runtime (csrc/msbwt_host.cpp).

Builds the shared library on first use (g++ -O3, links zlib) and caches it
next to the source. Every entry point has a pure-Python fallback, so the
package works without a toolchain; with it, FASTX parsing and RLE
encode/decode run at native speed (the reference's needletail + codec role).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger("msbwt_jax")

_CSRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
_SRCS = [
    os.path.join(_CSRC, "msbwt_host.cpp"),
    os.path.join(_CSRC, "msbwt_baseline.cpp"),
]
_LIB_DIR = os.path.join(os.path.dirname(__file__), "..", "_native")
_LIB = os.path.join(_LIB_DIR, "libmsbwt_host.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(_LIB_DIR, exist_ok=True)
    srcs = [os.path.abspath(s) for s in _SRCS if os.path.isfile(s)]
    if not srcs:
        return False
    if os.path.isfile(_LIB) and all(
        os.path.getmtime(_LIB) >= os.path.getmtime(s) for s in srcs
    ):
        return True
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           *srcs, "-o", _LIB, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.info("native host library unavailable (%s); using Python paths", e)
        return False


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("MSBWT_NO_NATIVE"):
            return None
        if not _build():
            return None
        lib = ctypes.CDLL(_LIB)
        lib.msbwt_parse_fastx.restype = ctypes.c_int
        lib.msbwt_parse_fastx.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.msbwt_free.argtypes = [ctypes.c_void_p]
        lib.msbwt_rle_decode.restype = ctypes.c_int64
        lib.msbwt_rle_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.msbwt_rle_encode.restype = ctypes.c_int64
        lib.msbwt_rle_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.msbwt_sort_rows.restype = ctypes.c_int
        lib.msbwt_sort_rows.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.msbwt_reads_to_cols.restype = ctypes.c_int
        lib.msbwt_reads_to_cols.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.msbwt_baseline_build.restype = ctypes.c_int64
        lib.msbwt_baseline_build.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.msbwt_baseline_count_kmers.restype = ctypes.c_int
        lib.msbwt_baseline_count_kmers.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
        ]
        lib.msbwt_baseline_index_only.restype = ctypes.c_int64
        lib.msbwt_baseline_index_only.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def parse_fastx_native(path: str):
    """Parse a FASTX file natively -> list of int-encoded reads, or None."""
    lib = get_lib()
    if lib is None:
        return None
    seq_p = ctypes.POINTER(ctypes.c_uint8)()
    offs_p = ctypes.POINTER(ctypes.c_int64)()
    total = ctypes.c_int64()
    n_reads = ctypes.c_int64()
    rc = lib.msbwt_parse_fastx(
        path.encode(), ctypes.byref(seq_p), ctypes.byref(total),
        ctypes.byref(offs_p), ctypes.byref(n_reads),
    )
    if rc != 0:
        raise ValueError(f"{path}: FASTX parse failed (code {rc})")
    try:
        n, t = n_reads.value, total.value
        seq = np.ctypeslib.as_array(seq_p, shape=(max(t, 1),))[:t].copy()
        offs = np.ctypeslib.as_array(offs_p, shape=(n + 1,)).copy()
    finally:
        lib.msbwt_free(seq_p)
        lib.msbwt_free(offs_p)
    return [seq[offs[i]:offs[i + 1]] for i in range(n)]


def rle_decode_native(rle: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    rle = np.ascontiguousarray(rle, dtype=np.uint8)
    p = rle.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    total = lib.msbwt_rle_decode(p, rle.size, None)
    out = np.empty(total, dtype=np.uint8)
    lib.msbwt_rle_decode(p, rle.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def rle_encode_native(syms: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    syms = np.ascontiguousarray(syms, dtype=np.uint8)
    p = syms.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    n_bytes = lib.msbwt_rle_encode(p, syms.size, None)
    out = np.empty(n_bytes, dtype=np.uint8)
    lib.msbwt_rle_encode(p, syms.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def sort_rows_native(reads: np.ndarray):
    """Lexicographic argsort of fixed-width uint8 rows, or None."""
    lib = get_lib()
    if lib is None:
        return None
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    n, l = reads.shape
    order = np.empty(n, dtype=np.int32)
    lib.msbwt_sort_rows(
        reads.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n), ctypes.c_int64(l),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return order


def reads_to_cols_native(reads: np.ndarray, lengths: np.ndarray,
                         order: np.ndarray | None = None):
    """Fused gather-by-order + column-major stage view, or None."""
    lib = get_lib()
    if lib is None:
        return None
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n, l = reads.shape
    cols = np.empty(((l + 2), n), dtype=np.uint8)
    order_p = (
        np.ascontiguousarray(order, dtype=np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32))
        if order is not None else None
    )
    lib.msbwt_reads_to_cols(
        reads.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        order_p, ctypes.c_int64(n), ctypes.c_int64(l),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return cols


# --- native CPU baseline (csrc/msbwt_baseline.cpp): the reference's exact
# sequential algorithms, measured for BENCH vs_baseline ------------------------


def baseline_build_native(reads: list, sorted_insert: bool = True):
    """Sequential reference-shape build (B+-tree sorted insertion) -> decoded
    BWT, or None without a toolchain. ``reads``: list of int-encoded arrays."""
    lib = get_lib()
    if lib is None:
        return None
    offsets = np.zeros(len(reads) + 1, dtype=np.int64)
    for i, r in enumerate(reads):
        offsets[i + 1] = offsets[i] + len(r)
    seq = np.concatenate([np.asarray(r, dtype=np.uint8) for r in reads]) \
        if reads else np.zeros(0, dtype=np.uint8)
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    out = np.empty(int(offsets[-1]) + len(reads), dtype=np.uint8)
    n = lib.msbwt_baseline_build(
        seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(reads)), ctypes.c_int(1 if sorted_insert else 0),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out[:n]


def baseline_count_kmers_native(rle_bytes: np.ndarray, kmers: np.ndarray,
                                lengths=None, bin_power: int = 8,
                                threads: int = 1):
    """Reference query loop (occ-bin seed + linear RLE decode) over a batch,
    or None without a toolchain. threads=1 is the reference-faithful config."""
    lib = get_lib()
    if lib is None:
        return None
    rle_bytes = np.ascontiguousarray(rle_bytes, dtype=np.uint8)
    kmers = np.ascontiguousarray(kmers, dtype=np.uint8)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    B, K = kmers.shape
    if lengths is None:
        lengths = np.full(B, K, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    out = np.empty(B, dtype=np.int64)
    rc = lib.msbwt_baseline_count_kmers(
        rle_bytes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(rle_bytes.size), ctypes.c_int(bin_power),
        kmers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(B), ctypes.c_int64(K),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(threads),
    )
    if rc != 0:
        raise RuntimeError(f"baseline count_kmers failed (code {rc})")
    return out
