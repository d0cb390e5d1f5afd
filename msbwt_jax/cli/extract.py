"""``msbwt2-extract``: recover reads from a BWT (lossless archive).

No reference equivalent (the Rust tool has build/convert only; the original
Python msbwt exposed extraction). Prints FASTA to stdout: record ``i`` is
the i-th read in the BWT's stored (lexicographic, for sorted builds) order.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

EX_NOINPUT = 66
EX_IOERR = 74


def _parse_ranges(specs, n_strings):
    ids = []
    for spec in specs:
        if "-" in spec:
            a, b = spec.split("-", 1)
            ids.extend(range(int(a), int(b) + 1))
        else:
            ids.append(int(spec))
    if not ids:
        ids = list(range(n_strings))
    return ids


def main(argv=None) -> int:
    logging.basicConfig(
        level=os.environ.get("RUST_LOG", "info").upper(),
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    logger = logging.getLogger("msbwt2-extract")

    parser = argparse.ArgumentParser(
        prog="msbwt2-extract",
        description="Recover reads from a msbwt2 BWT "
        "(JAX implementation)",
    )
    parser.add_argument("BWT", help="comp_msbwt.npy file")
    parser.add_argument(
        "RANGE", nargs="*",
        help="read indices or inclusive ranges like 10-20 (default: all)",
    )
    args = parser.parse_args(argv)

    from msbwt_jax.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    if not os.path.isfile(args.BWT):
        logger.error("Failed to open BWT file: %r", args.BWT)
        return EX_NOINPUT

    import numpy as np  # noqa: F401

    from msbwt_jax.models.rle_bwt import RleBWT
    from msbwt_jax.ops.alphabet import convert_itos
    from msbwt_jax.ops.extract import extract_reads

    try:
        bwt = RleBWT()
        bwt.load_numpy_file(args.BWT)
    except (OSError, IOError) as e:
        logger.error("Error loading BWT: %s", e)
        return EX_IOERR
    n_strings = int(bwt.get_symbol_count(0))
    try:
        ids = _parse_ranges(args.RANGE, n_strings)
    except ValueError as e:
        logger.error("Bad range: %s", e)
        return EX_NOINPUT
    try:
        reads = extract_reads(bwt.device_index, ids, n_strings)
    except ValueError as e:
        logger.error("%s", e)
        return EX_NOINPUT
    out = sys.stdout
    for i, r in zip(ids, reads):
        out.write(f">read_{i}\n{convert_itos(r)}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
