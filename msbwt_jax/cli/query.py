"""``msbwt2-query``: batched k-mer counting from the command line.

The reference ships no query CLI (queries are library-only); this rounds out
the tool surface: load a ``comp_msbwt.npy`` BWT, count every k-mer given as
arguments or one-per-line from a file/stdin, print ``kmer<TAB>count``.

Exit codes follow the builder's convention (66 NOINPUT, 74 IOERR).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

EX_NOINPUT = 66
EX_IOERR = 74


def main(argv=None) -> int:
    logging.basicConfig(
        level=os.environ.get("RUST_LOG", "info").upper(),
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    logger = logging.getLogger("msbwt2-query")

    parser = argparse.ArgumentParser(
        prog="msbwt2-query",
        description="Batched k-mer counts over a msbwt2 BWT "
        "(JAX implementation)",
    )
    parser.add_argument("BWT", help="comp_msbwt.npy file")
    parser.add_argument("KMER", nargs="*", help="k-mers ($ACGNT strings)")
    parser.add_argument(
        "-i", "--input", default=None,
        help="file with one k-mer per line ('-' for stdin)",
    )
    parser.add_argument(
        "--cache-k", type=int, default=0, metavar="K",
        help="precompute a 6^K prefix-range cache before querying",
    )
    parser.add_argument(
        "--index-pack", default=None, metavar="NPZ",
        help="query-index sidecar: loaded if it exists, else derived "
        "indexes are saved there for the next run",
    )
    parser.add_argument(
        "--locate", action="store_true",
        help="also print one 'kmer<TAB>read_id<TAB>offset' line per "
        "occurrence (read ids are lexicographic; the id space of "
        "msbwt2-extract)",
    )
    parser.add_argument(
        "--max-mismatch", type=int, default=0, metavar="D", choices=(0, 1),
        help="count occurrences within Hamming distance D (0 or 1; "
        "D=1 resolves all single-substitution variants in one batch)",
    )
    args = parser.parse_args(argv)

    from msbwt_jax.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    if not os.path.isfile(args.BWT):
        logger.error("Failed to open BWT file: %r", args.BWT)
        return EX_NOINPUT

    kmers_txt = list(args.KMER)
    if args.input is not None:
        try:
            import contextlib

            fp = sys.stdin if args.input == "-" else open(args.input)
            cm = contextlib.nullcontext(fp) if fp is sys.stdin else fp
            with cm:
                kmers_txt += [ln.strip() for ln in fp if ln.strip()]
        except OSError as e:
            logger.error("Failed to read k-mers: %s", e)
            return EX_NOINPUT
    if not kmers_txt:
        logger.error("No k-mers given (arguments or --input)")
        return EX_NOINPUT

    import numpy as np

    from msbwt_jax.models.rle_bwt import RleBWT
    from msbwt_jax.ops.alphabet import convert_stoi

    try:
        bwt = RleBWT()
        bwt.load_numpy_file(args.BWT)
    except (OSError, IOError) as e:
        logger.error("Error loading BWT: %s", e)
        return EX_IOERR
    pack_loaded = False
    if args.index_pack and os.path.isfile(args.index_pack):
        import zipfile

        # np.load raises ValueError for non-zip bytes, zipfile.BadZipFile
        # for a truncated archive, KeyError for an npz missing our arrays —
        # all of them are "bad pack", not a crash.
        try:
            bwt.load_query_indexes(args.index_pack)
            pack_loaded = True
            logger.info("Loaded query indexes from %r", args.index_pack)
        except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
            logger.error("Bad index pack: %s", e)
            return EX_IOERR
    pack_stale = False
    if args.cache_k > 0 and getattr(bwt, "_cache_k", 0) != args.cache_k:
        bwt.enable_kmer_cache(args.cache_k)
        pack_stale = True  # new cache worth persisting into the pack

    K = max(len(k) for k in kmers_txt)
    B = len(kmers_txt)
    kmers = np.zeros((B, K), dtype=np.uint8)
    lengths = np.empty(B, dtype=np.int32)
    for i, txt in enumerate(kmers_txt):
        enc = convert_stoi(txt)
        kmers[i, K - len(enc):] = enc
        lengths[i] = len(enc)
    if args.max_mismatch:
        counts = bwt.count_kmers_approx(kmers, lengths,
                                        max_mismatch=args.max_mismatch)
    else:
        counts = bwt.count_kmers(kmers, lengths)
    if args.index_pack and (not pack_loaded or pack_stale):
        try:
            bwt.save_query_indexes(args.index_pack)
            logger.info("Saved query indexes to %r", args.index_pack)
        except OSError as e:
            logger.warning("Could not save index pack: %s", e)
    out = sys.stdout
    for txt, cnt in zip(kmers_txt, counts.tolist()):
        out.write(f"{txt}\t{cnt}\n")
    if args.locate:
        from msbwt_jax.ops.extract import locate_kmers

        n_strings = bwt.get_symbol_count(0)
        q, r, o = locate_kmers(bwt.device_index, kmers, n_strings,
                               lengths=lengths)
        for qi, rid, off in zip(q.tolist(), r.tolist(), o.tolist()):
            out.write(f"{kmers_txt[qi]}\t{rid}\t{off}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
