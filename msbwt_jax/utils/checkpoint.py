"""Checkpoint / resume (SURVEY.md §5).

In the reference, the ``.npy`` file *is* the checkpoint and resume means
reloading + inserting more strings (ref: src/lib.rs:30-43, test
src/dynamic_bwt.rs:734-773 — where load is an O(n) one-symbol-at-a-time
reinsert). Here:

* the same ``.npy`` remains the portable checkpoint (byte-compatible);
* ``save_index_cache``/``load_index_cache`` additionally persist the decoded
  device index (occ tables + C array) so a query service restarts without
  re-deriving anything;
* ``save_sharded``/``load_sharded`` split one BWT into per-shard npy files
  plus a manifest, so each host of a pod loads only its slice (each shard
  file is itself a valid ``comp_msbwt.npy`` of its contiguous BWT slice).
"""

from __future__ import annotations

import json
import os

import numpy as np

from msbwt_jax.ops.alphabet import VC_LEN
from msbwt_jax.ops.rle import bytes_from_runs, decode_symbols, runs_from_symbols
from msbwt_jax.utils.npy import load_bwt_bytes, save_bwt_bytes


def save_index_cache(index, path: str) -> None:
    """Persist an ``ops.rank.OccIndex`` (npz sidecar next to the npy)."""
    np.savez_compressed(
        path,
        bwt=np.asarray(index.bwt),
        occ=np.asarray(index.occ),
        starts=np.asarray(index.starts),
        n=np.int64(index.n),
    )


def load_index_cache(path: str):
    import jax.numpy as jnp

    from msbwt_jax.ops.rank import OccIndex

    with np.load(path) as z:
        return OccIndex(
            bwt=jnp.asarray(z["bwt"]),
            occ=jnp.asarray(z["occ"]),
            starts=jnp.asarray(z["starts"]),
            n=int(z["n"]),
        )


_QUERY_PACK_FORMAT = "msbwt_jax.query_pack.v1"


def save_query_pack(path: str, *, packed=None, pair=None, cache=None,
                    cache_k: int = 0) -> None:
    """Persist derived QUERY indexes (one ``.npz`` sidecar) so a query
    service restart is a disk load instead of a re-derivation.

    Any subset of the three index structures can be saved: ``packed``
    (:class:`ops.packed_rank.PackedOccIndex`), ``pair``
    (:class:`ops.pair_rank.PairIndex`) and ``cache``
    (:class:`ops.rank.KmerCache`, with its ``cache_k``). The pack is
    self-validating on load via the C array and BWT length.

    Whether loading a multi-GB pack beats re-deriving it on device is not
    measured on the H100.

    >>> import tempfile, os
    >>> from msbwt_jax.ops.alphabet import convert_stoi
    >>> from msbwt_jax.ops.rank import build_occ_index
    >>> from msbwt_jax.ops.packed_rank import pack_index, count_kmers_packed
    >>> from msbwt_jax.utils.oracle import naive_bwt
    >>> idx = build_occ_index(convert_stoi(naive_bwt(["ACGT", "TGCA"])))
    >>> with tempfile.TemporaryDirectory() as td:
    ...     p = os.path.join(td, "pack.npz")
    ...     save_query_pack(p, packed=pack_index(idx))
    ...     packed, pair, cache, ck = load_query_pack(p)
    >>> int(count_kmers_packed(packed, convert_stoi("ACGT"))[0])
    1
    """
    if packed is None and pair is None:
        raise ValueError("save_query_pack needs at least packed= or pair=")
    src = packed if packed is not None else pair
    arrays = {
        "format": np.asarray(_QUERY_PACK_FORMAT),
        "n": np.int64(src.n),
        "starts": np.asarray(src.starts),
    }
    if packed is not None:
        arrays["packed_table"] = np.asarray(packed.table)
    if pair is not None:
        if int(pair.n) != int(src.n):
            raise ValueError("packed/pair index n mismatch")
        arrays["pair_table2"] = np.asarray(pair.table2)
        arrays["pair_dmat"] = np.asarray(pair.dmat)
    if cache is not None:
        if cache_k <= 0:
            raise ValueError("cache= requires cache_k > 0")
        arrays["cache_lo"] = np.asarray(cache.lo)
        arrays["cache_hi"] = np.asarray(cache.hi)
        arrays["cache_k"] = np.int64(cache_k)
    # np.savez(str_path) appends ".npz" when the extension is missing, which
    # would break the save -> os.path.isfile -> load round trip for paths
    # like "idx.pack"; a file handle writes to the exact name given.
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def load_query_pack(path: str):
    """Load a :func:`save_query_pack` sidecar.

    Returns ``(packed, pair, cache, cache_k)`` — members are ``None`` / 0
    when absent from the pack. Arrays land on the default device.
    """
    import jax.numpy as jnp

    from msbwt_jax.ops.packed_rank import PackedOccIndex
    from msbwt_jax.ops.pair_rank import PairIndex
    from msbwt_jax.ops.rank import KmerCache

    with np.load(path) as z:
        if str(z["format"]) != _QUERY_PACK_FORMAT:
            raise IOError(f"not a query pack: {path!r} ({z['format']})")
        n = int(z["n"])
        starts = jnp.asarray(z["starts"])
        packed = pair = cache = None
        cache_k = 0
        if "packed_table" in z:
            packed = PackedOccIndex(
                table=jnp.asarray(z["packed_table"]), starts=starts, n=n
            )
        if "pair_table2" in z:
            pair = PairIndex(
                table2=jnp.asarray(z["pair_table2"]), starts=starts,
                dmat=jnp.asarray(z["pair_dmat"]), n=n,
            )
        if "cache_lo" in z:
            cache = KmerCache(
                lo=jnp.asarray(z["cache_lo"]), hi=jnp.asarray(z["cache_hi"])
            )
            cache_k = int(z["cache_k"])
    return packed, pair, cache, cache_k


def save_sharded(decoded: np.ndarray, directory: str, n_shards: int) -> None:
    """Split a decoded BWT into ``n_shards`` contiguous slices, each saved as
    a standalone ``comp_msbwt.npy``, plus ``manifest.json`` with boundaries
    and global symbol totals.

    >>> import numpy as np, tempfile
    >>> d = np.array([5, 0, 1, 2, 3, 4], np.uint8)
    >>> with tempfile.TemporaryDirectory() as td:
    ...     save_sharded(d, td, n_shards=2)
    ...     m = load_manifest(td)
    ...     ok = np.array_equal(load_sharded(td), d)
    >>> (m["n_shards"], m["total_size"], ok)
    (2, 6, True)
    """
    decoded = np.asarray(decoded, dtype=np.uint8)
    os.makedirs(directory, exist_ok=True)
    n = int(decoded.size)
    bounds = [round(i * n / n_shards) for i in range(n_shards + 1)]
    for d in range(n_shards):
        sl = decoded[bounds[d] : bounds[d + 1]]
        syms, counts = runs_from_symbols(sl)
        save_bwt_bytes(bytes_from_runs(syms, counts), _shard_path(directory, d))
    totals = np.bincount(decoded, minlength=VC_LEN)[:VC_LEN]
    manifest = {
        "format": "msbwt_jax.sharded_bwt.v1",
        "n_shards": n_shards,
        "total_size": n,
        "boundaries": bounds,
        "symbol_counts": totals.tolist(),
    }
    with open(os.path.join(directory, "manifest.json"), "w") as fp:
        json.dump(manifest, fp, indent=1)


def load_manifest(directory: str) -> dict:
    with open(os.path.join(directory, "manifest.json")) as fp:
        return json.load(fp)


def load_shard(directory: str, shard: int) -> np.ndarray:
    """Decoded symbols of one shard (what a single host needs)."""
    return decode_symbols(load_bwt_bytes(_shard_path(directory, shard)))


def load_sharded(directory: str) -> np.ndarray:
    """Reassemble the full decoded BWT from a sharded checkpoint."""
    m = load_manifest(directory)
    parts = [load_shard(directory, d) for d in range(m["n_shards"])]
    out = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    if out.size != m["total_size"]:
        raise IOError(
            f"sharded checkpoint corrupt: {out.size} != {m['total_size']}"
        )
    return out


def _shard_path(directory: str, d: int) -> str:
    return os.path.join(directory, f"shard_{d:05d}.npy")
