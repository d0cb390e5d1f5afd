"""``msbwt2-build`` equivalent: FASTX file(s) -> MSBWT -> npy or stdout.

Flag surface mirrors the reference (ref: src/bin/msbwt2-build.rs:23-41):
``-o/--out-bwt`` (default stdout) and one or more positional FASTX files
(FASTA/FASTQ, gzip accepted). Like the reference, insertion order is always
lexicographical — the reference parses an ``unsorted`` flag but never
registers it (ref: src/bin/msbwt2-build.rs:45-47), so sorted is the only
behavior; we expose ``--unsorted`` as a working option since our builder
supports both.

Exit codes follow the reference's exitcode usage: 66 NOINPUT, 73 CANTCREAT,
74 IOERR (ref: src/bin/msbwt2-build.rs:68,80,91,108).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

EX_NOINPUT = 66
EX_CANTCREAT = 73
EX_IOERR = 74


def main(argv=None) -> int:
    logging.basicConfig(
        level=os.environ.get("RUST_LOG", "info").upper(),
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    logger = logging.getLogger("msbwt2-build")

    parser = argparse.ArgumentParser(
        prog="msbwt2-build",
        description="msbwt2 BWT Builder - will construct a BWT from one or "
        "more FASTX files",
    )
    parser.add_argument(
        "-o", "--out-bwt", dest="out_bwt", default="stdout",
        help="The output BWT (default: stdout)",
    )
    parser.add_argument(
        "--unsorted", action="store_true",
        help="Insert strings chronologically instead of lexicographically",
    )
    parser.add_argument(
        "--batch-size", type=int, default=0, metavar="N",
        help="Stream reads through the builder N at a time (bounded device "
        "memory; 0 = one batch per file)",
    )
    parser.add_argument(
        "--distributed", action="store_true",
        help="Multi-host build: jax.distributed init, per-process record "
        "stripe ingestion, distributed D-way merge; run one process per "
        "host (see parallel/multihost.py for the launch recipe)",
    )
    parser.add_argument(
        "FASTX", nargs="+",
        help="The FASTQ/A file(s) to load into the BWT, gzip accepted",
    )
    args = parser.parse_args(argv)

    from msbwt_jax.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    sorted_strings = not args.unsorted

    logger.info("Input parameters (required):")
    logger.info("\tFASTX: %s", args.FASTX)
    logger.info("\tout_bwt: %r", args.out_bwt)
    logger.info("Optional Parameters:")
    logger.info(
        "\tsort order: %s",
        "lexicographical" if sorted_strings else "chronological",
    )

    for fn in args.FASTX:
        if not os.path.isfile(fn):
            logger.error("Failed to open FASTX file: %r", fn)
            return EX_NOINPUT

    if args.out_bwt != "stdout":
        try:
            with open(args.out_bwt, "w"):
                pass
        except OSError as e:
            logger.error("Failed to create output BWT file: %r", args.out_bwt)
            logger.error("Error: %s", e)
            return EX_CANTCREAT

    from msbwt_jax.models.dynamic import create_from_fastx
    from msbwt_jax.ops.alphabet import convert_itos
    from msbwt_jax.ops.rle import runs_from_symbols
    from msbwt_jax.utils.npy import save_bwt_runs

    try:
        if args.distributed:
            from msbwt_jax.models.dynamic import DynamicBWT
            from msbwt_jax.parallel.multihost import (
                build_from_fastx_distributed,
            )

            decoded, is_zero = build_from_fastx_distributed(
                args.FASTX, sorted_strings
            )
            if not is_zero:  # only process 0 writes output
                logger.info("Non-zero process finished; skipping output.")
                return 0
            bwt = DynamicBWT.from_decoded(decoded)
        elif args.batch_size > 0:
            from msbwt_jax.models.dynamic import create_from_fastx_streaming

            bwt = create_from_fastx_streaming(
                args.FASTX, sorted_strings, batch_size=args.batch_size
            )
        else:
            bwt = create_from_fastx(args.FASTX, sorted_strings)
    except Exception as e:  # parse errors
        logger.error("Error while parsing FASTX files: %s", args.FASTX)
        logger.error("Error: %s", e)
        return EX_IOERR

    if args.out_bwt == "stdout":
        sys.stdout.write(convert_itos(bwt.to_vec()))
        sys.stdout.write("\n")
    else:
        logger.info("Saving results to file: %r", args.out_bwt)
        try:
            syms, counts = runs_from_symbols(bwt.to_vec())
            save_bwt_runs(syms, counts, args.out_bwt)
        except OSError as e:
            logger.error("Error saving BWT to file: %r", args.out_bwt)
            logger.error("Error: %s", e)
            return EX_IOERR

    logger.info("Processes successfully finished.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
