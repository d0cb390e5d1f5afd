"""L1 — the RLE byte-stream codec (vectorized, numpy host-side).

Format contract (ref: src/bwt_converter.rs:53-56,163-168; decoder semantics at
src/rle_bwt.rs:360-371): each byte = ``symbol (low 3 bits) | count_digit << 3``
with ``count_digit in [0, 31]``. A run's count is emitted as little-endian
base-32 digits, one byte per digit, every byte carrying the SAME symbol; a
decoder treats consecutive same-symbol bytes as a single run accumulated with
``power_multiple *= 32``. Zero digits are legal interior/leading digits
(``"A"*3104 -> [1, 9, 25]``, ref test src/bwt_converter.rs:220-227). Encoders
never merge across differing adjacent runs and assume the input run iterator
has no two consecutive runs with equal symbol (ref: src/bwt_converter.rs:136).

Everything here is vectorized numpy — these run on host as part of load/save;
the device query/build paths use the decoded representations.
"""

from __future__ import annotations

import numpy as np

from msbwt_jax.ops.alphabet import COUNT_MASK, LETTER_BITS, MASK, VC_LEN

_MAX_DIGITS = 13  # ceil(64 / 5): a u64 count has at most 13 base-32 digits


def runs_from_bytes(rle: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decode RLE bytes into maximal runs ``(symbols u8[R], counts u64[R])``.

    Consecutive bytes with the same symbol are one run with base-32
    little-endian digit accumulation (ref: src/rle_bwt.rs:360-371).
    """
    rle = np.asarray(rle, dtype=np.uint8)
    if rle.size == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.uint64)
    syms = rle & MASK
    digits = (rle >> LETTER_BITS).astype(np.uint64)
    is_start = np.empty(rle.size, dtype=bool)
    is_start[0] = True
    np.not_equal(syms[1:], syms[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    group_id = np.cumsum(is_start) - 1
    k = np.arange(rle.size, dtype=np.uint64) - starts[group_id].astype(np.uint64)
    contrib = digits << (np.uint64(5) * k)  # wraps mod 2**64 like the reference
    counts = np.add.reduceat(contrib, starts)
    return syms[starts], counts.astype(np.uint64)


def runs_from_bytes_with_offsets(
    rle: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Like ``runs_from_bytes`` but also returns each run's byte offset
    (needed by the run-boundary-sampled FM-index parity structure,
    ref: src/rle_bwt.rs:421-444)."""
    rle = np.asarray(rle, dtype=np.uint8)
    if rle.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.uint64), z
    syms = rle & MASK
    is_start = np.empty(rle.size, dtype=bool)
    is_start[0] = True
    np.not_equal(syms[1:], syms[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    run_syms, run_counts = runs_from_bytes(rle)
    return run_syms, run_counts, starts.astype(np.int64)


def bytes_from_runs(syms: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Encode maximal runs into RLE bytes (ref: src/bwt_converter.rs:161-169).

    >>> bytes_from_runs([1], [3104]).tolist()  # 'A'x3104 -> digits 0,1,3
    [1, 9, 25]
    >>> bytes_from_runs([4], [32767]).tolist() == [0xFC] * 3  # 'N'x32767
    True

    Each count >= 1 becomes little-endian base-32 digits; every digit byte
    carries the run's symbol. Assumes no two consecutive runs share a symbol.
    """
    syms = np.asarray(syms, dtype=np.uint8)
    counts = np.asarray(counts, dtype=np.uint64)
    if syms.size == 0:
        return np.zeros(0, dtype=np.uint8)
    if counts.min() < 1:
        raise ValueError("run counts must be >= 1")
    shifts = np.uint64(5) * np.arange(_MAX_DIGITS, dtype=np.uint64)
    shifted = counts[:, None] >> shifts[None, :]          # [R, 13]
    mask = shifted > 0                                    # monotone: keeps interior zero digits
    mask[:, 0] = True                                     # count>=1 always emits >=1 byte
    digit = (shifted & np.uint64(COUNT_MASK)).astype(np.uint8)
    byte = syms[:, None] | (digit << LETTER_BITS)
    return byte[mask]  # row-major flatten == little-endian digit order per run


def runs_from_symbols(decoded: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Extract maximal runs from a decoded symbol array.

    >>> syms, counts = runs_from_symbols([0, 1, 1, 1, 2])
    >>> syms.tolist(), counts.tolist()
    ([0, 1, 2], [1, 3, 1])
    """
    decoded = np.asarray(decoded, dtype=np.uint8)
    if decoded.size == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.uint64)
    is_start = np.empty(decoded.size, dtype=bool)
    is_start[0] = True
    np.not_equal(decoded[1:], decoded[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    lengths = np.diff(np.append(starts, decoded.size)).astype(np.uint64)
    return decoded[starts], lengths


def decode_symbols(rle: np.ndarray) -> np.ndarray:
    """Fully decode RLE bytes into the flat symbol array (uint8).

    Uses the native host library when available (csrc/msbwt_host.cpp),
    falling back to the vectorized numpy path."""
    from msbwt_jax.utils.native import rle_decode_native

    native = rle_decode_native(np.asarray(rle, dtype=np.uint8))
    if native is not None:
        return native
    syms, counts = runs_from_bytes(rle)
    return np.repeat(syms, counts.astype(np.int64))


def _run_aligned_bounds(rle: np.ndarray, chunk: int):
    """Yield ``(i, j)`` chunk bounds that never split a run. Extending a
    boundary to the next symbol change costs <= 6 byte probes (a run's
    base-32 digit string has <= 7 bytes below 2^31 and same-symbol runs are
    never adjacent, ref: src/bwt_converter.rs:136)."""
    i, total = 0, int(rle.size)
    while i < total:
        j = min(i + chunk, total)
        if j < total:
            s = rle[j - 1] & MASK
            while j < total and (rle[j] & MASK) == s:
                j += 1
        yield i, j
        i = j


def rle_meta(rle: np.ndarray, chunk: int = 1 << 22):
    """One CHUNKED pass over the compressed bytes: ``(n, symbol_counts, runs)``.

    The load path's eager host work (the equivalent of ``calculate_totals``,
    ref: src/rle_bwt.rs:352-384) — peak temporary memory is O(chunk), so
    loading a multi-GB BWT never materializes position- or run-proportional
    host arrays beyond the byte vector itself.
    """
    rle = np.asarray(rle, dtype=np.uint8)
    n = 0
    n_runs = 0
    counts = np.zeros(VC_LEN, dtype=np.uint64)
    for i, j in _run_aligned_bounds(rle, chunk):
        syms, rcounts = runs_from_bytes(rle[i:j])
        n += int(rcounts.sum())
        n_runs += int(syms.size)
        for s in range(VC_LEN):
            counts[s] += int(rcounts[syms == s].sum())
    return n, counts, n_runs


def _upload_bytes(rle: np.ndarray, chunk: int = 1 << 22):
    """Host->device transfer of the raw byte vector in bounded chunks (the
    host never pins more than ``chunk`` bytes beyond the vector itself)."""
    import jax
    import jax.numpy as jnp

    rle = np.asarray(rle, dtype=np.uint8)
    if rle.size <= chunk:
        return jnp.asarray(rle)
    parts = [jax.device_put(rle[i : i + chunk])
             for i in range(0, rle.size, chunk)]
    return jnp.concatenate(parts)


def decode_symbols_device(rle: np.ndarray, n: int):
    """Decode RLE bytes into the flat symbol array ON DEVICE (uint8 [n]).

    The wire carries the COMPRESSED bytes (<= the decoded size, usually far
    less) and the host never materializes the decoded array — the fix for
    the load path's host double-materialization. ``n`` must be the true
    decoded length (from :func:`rle_meta`); device work is a boundary scan +
    one ``jnp.repeat`` where each byte contributes its base-32 digit term
    ``digit * 32^k`` directly (all bytes of a run carry the same symbol, so
    per-byte repeats compose to exactly the run, in order).
    """
    import jax.numpy as jnp

    if n >= 2**31:
        raise ValueError("decode_symbols_device requires n < 2^31")
    rle = np.asarray(rle, dtype=np.uint8)
    if rle.size == 0:
        return jnp.zeros(0, dtype=jnp.uint8)
    return _decode_device_impl(_upload_bytes(rle), n)


_DECODE_JIT = None


def _decode_device_impl(rle, n: int):
    """jit-compiled device decode (jax imported lazily — this module is
    otherwise numpy-only host code)."""
    global _DECODE_JIT
    if _DECODE_JIT is None:
        import jax

        _DECODE_JIT = jax.jit(_decode_device_jit_fn, static_argnames=("n",))
    return _DECODE_JIT(rle, n=n)


def _decode_device_jit_fn(rle, *, n: int):
    import jax
    import jax.numpy as jnp

    sym = rle & np.uint8(MASK)
    digit = (rle >> LETTER_BITS).astype(jnp.int32)
    m = rle.shape[0]
    ar = jnp.arange(m, dtype=jnp.int32)
    boundary = jnp.concatenate(
        [jnp.ones(1, dtype=bool), sym[1:] != sym[:-1]]
    )
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(boundary, ar, 0)
    )
    # digit index within the run; <= 6 for any valid n < 2^31 (a count's
    # base-32 string has <= 7 digits) — clamped so corrupt input cannot
    # produce an undefined >= 32-bit shift
    k = jnp.minimum(ar - run_start, 6)
    term = digit << (5 * k)  # == digit * 32^k, <= the run count < 2^31
    return jnp.repeat(sym, term, total_repeat_length=n)


def symbol_counts_from_bytes(rle: np.ndarray) -> np.ndarray:
    """Total occurrences of each symbol, from the compressed form
    (equivalent of ``calculate_totals``, ref: src/rle_bwt.rs:352-384)."""
    syms, counts = runs_from_bytes(rle)
    totals = np.zeros(VC_LEN, dtype=np.uint64)
    np.add.at(totals, syms, counts)
    return totals


def convert_to_vec(stream) -> np.ndarray:
    """Char stream -> compressed RLE byte vector (ref: src/bwt_converter.rs:26-80).

    Accepts ``bytes``/``str``/uint8 array of ``$ACGNT`` characters; newline
    bytes are ignored (including mid-run: a run continues across a newline,
    ref test src/bwt_converter.rs:209-217); any other byte is an error.
    """
    if isinstance(stream, str):
        stream = stream.encode("latin-1")
    raw = np.frombuffer(bytes(stream), dtype=np.uint8) if not isinstance(
        stream, np.ndarray
    ) else np.asarray(stream, dtype=np.uint8)
    raw = raw[raw != 0x0A]  # drop newlines (ref: src/bwt_converter.rs:42-47)
    translate = np.full(256, 255, dtype=np.uint8)
    for i, ch in enumerate(b"$ACGNT"):
        translate[ch] = i
    translated = translate[raw]
    if np.any(translated == 255):
        bad = raw[translated == 255][0]
        raise ValueError(f'Unexpected symbol in input: char "{chr(bad)}"')
    syms, counts = runs_from_symbols(translated)
    return bytes_from_runs(syms, counts)
