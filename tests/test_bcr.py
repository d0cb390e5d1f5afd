"""Construction-kernel tests: BCR batched build vs the naive oracle.

Mirrors the reference's oracle-based construction tests
(src/dynamic_bwt.rs:475-577) plus randomized sweeps.
"""

import numpy as np

from msbwt_jax.ops.alphabet import convert_itos, convert_stoi
from msbwt_jax.ops.bcr import build_msbwt, encode_reads
from msbwt_jax.utils.oracle import naive_bwt


def _build(strings, sorted_insert=True, base=None, base_string_count=0):
    reads, lengths = encode_reads([convert_stoi(s) for s in strings])
    return build_msbwt(
        reads, lengths, sorted_insert=sorted_insert,
        base=base, base_string_count=base_string_count,
    )


def _check_vs_naive(strings):
    got = convert_itos(_build(strings))
    assert got == naive_bwt(strings), f"inputs={strings}"


def test_single_string():
    # ref: src/dynamic_bwt.rs:490-496 (unsorted single == sorted single)
    out = _build(["ACGNT"], sorted_insert=False)
    assert out.tolist() == [5, 0, 1, 2, 3, 4]
    _check_vs_naive(["ACGNT"])


def test_multi_string_sorted_order_independent():
    # ref: src/dynamic_bwt.rs:514-525 — non-lexicographic input order
    data = ["ACG", "N", "CCGT", "N", "ACG", "ACG", "CCGT", "N"]
    _check_vs_naive(data)


def test_multi_string_unsorted_chronological():
    # ref: src/dynamic_bwt.rs:498-512 — unsorted inserts of pre-sorted data
    data = sorted(["CCGT", "ACG", "N"])
    out = _build(data, sorted_insert=False)
    assert convert_itos(out) == "GTN$$ACCC$G"


def test_multi_length():
    # ref: src/dynamic_bwt.rs:527-548
    _check_vs_naive(["A", "AA", "AAA", "AAAA", "AAAAA"])
    _check_vs_naive(["AAAAA", "AAAA", "AAA", "AA", "A"])


def test_cycle_semantics():
    # suffix ties must break by full cyclic read comparison (src/bwt_util.rs:221-236)
    _check_vs_naive(["ACA", "CA"])
    _check_vs_naive(["CA", "ACA"])


def test_empty_and_tiny_strings():
    _check_vs_naive([""])
    _check_vs_naive(["", "A"])
    _check_vs_naive(["A", "", "AA"])


def test_duplicates():
    _check_vs_naive(["ACGT", "ACGT", "ACGT"])


def test_sampled_genome():
    # ref: src/dynamic_bwt.rs:550-577 — 32x coverage reads from a 56bp genome
    genome = "ACCGTGTTGCCGTAGTGAAAAGTGACGACGTGAGATGGCCAAAGTGGGTCTCTGTG"
    read_length, coverage = 20, 32
    data = []
    for s in range(len(genome) - read_length):
        data.extend([genome[s : s + read_length]] * coverage)
    _check_vs_naive(data)


def test_incremental_extension():
    # ref load-and-add flow: src/dynamic_bwt.rs:734-773
    first = ["CCGTACGTA", "GGTACAGTA", "ACGACGACG"]
    base = _build(first)
    extended = _build(["AAGTCATAT"], base=base, base_string_count=3)
    assert convert_itos(extended) == naive_bwt(first + ["AAGTCATAT"])


def test_incremental_extension_batch():
    first = ["TTGA", "CAT"]
    base = _build(first)
    extended = _build(["GG", "AC", "CATT"], base=base, base_string_count=2)
    assert convert_itos(extended) == naive_bwt(first + ["GG", "AC", "CATT"])


def test_random_collections(rng):
    alphabet = "ACGNT"
    for trial in range(15):
        n_reads = int(rng.integers(1, 30))
        data = [
            "".join(rng.choice(list(alphabet), size=int(rng.integers(1, 25))))
            for _ in range(n_reads)
        ]
        _check_vs_naive(data)


def test_random_incremental(rng):
    alphabet = "ACGT"
    for trial in range(8):
        all_reads = [
            "".join(rng.choice(list(alphabet), size=int(rng.integers(1, 15))))
            for _ in range(int(rng.integers(2, 15)))
        ]
        split = int(rng.integers(1, len(all_reads)))
        base = _build(all_reads[:split])
        ext = _build(all_reads[split:], base=base, base_string_count=split)
        assert convert_itos(ext) == naive_bwt(all_reads)


def test_build_with_index_matches_separate_derivation(rng):
    """Fused index derivation (straight off the build's device state) must
    equal build -> build_occ_index -> pack_index from decoded symbols."""
    import jax.numpy as jnp

    from msbwt_jax.ops.bcr import build_msbwt, build_msbwt_with_index
    from msbwt_jax.ops.packed_rank import count_kmers_packed, pack_index
    from msbwt_jax.ops.rank import build_occ_index

    reads = rng.integers(1, 6, size=(40, 12)).astype(np.uint8)
    lengths = np.full(40, 12, np.int32)
    decoded = build_msbwt(reads, lengths, engine="fused")
    want_idx = build_occ_index(jnp.asarray(decoded))
    want_packed = pack_index(want_idx)

    idx, packed = build_msbwt_with_index(reads, lengths, engine="fused")
    assert idx.n == want_idx.n
    assert np.array_equal(np.asarray(idx.bwt), np.asarray(want_idx.bwt))
    assert np.array_equal(np.asarray(idx.occ), np.asarray(want_idx.occ))
    assert np.array_equal(np.asarray(idx.starts), np.asarray(want_idx.starts))
    assert np.array_equal(
        np.asarray(packed.table), np.asarray(want_packed.table)
    )

    # and the derived index answers queries identically
    kmers = reads[:16, :8].copy()
    got = count_kmers_packed(packed, kmers)
    want = count_kmers_packed(want_packed, kmers)
    assert got.tolist() == want.tolist()


def test_build_with_index_xla_fallback(rng):
    """The XLA engine path of build_msbwt_with_index matches."""
    from msbwt_jax.ops.bcr import build_msbwt, build_msbwt_with_index
    from msbwt_jax.ops.rank import count_kmers

    reads = rng.integers(1, 6, size=(25, 9)).astype(np.uint8)
    lengths = np.full(25, 9, np.int32)
    decoded = build_msbwt(reads, lengths, engine="xla")
    idx, packed = build_msbwt_with_index(reads, lengths, engine="xla")
    assert np.array_equal(np.asarray(idx.bwt)[: idx.n], decoded)
    got = count_kmers(idx, reads[:10, :6].copy())
    assert all(c >= 1 for c in got.tolist())


def test_radix2_matches_oracle(monkeypatch, rng):
    """Radix-2 stages (two columns per merge pass) must equal the oracle on
    sorted, chronological, variable-length, duplicate and extend cases.
    Forced via MSBWT_RADIX=2 (auto mode picks radix 1 for short reads)."""
    monkeypatch.setenv("MSBWT_RADIX", "2")
    for trial in range(3):
        n = int(rng.integers(5, 40))
        reads_l = [rng.integers(1, 6, int(rng.integers(1, 25))).astype(np.uint8)
                   for _ in range(n)]
        if n > 3:
            reads_l[1] = reads_l[0].copy()  # duplicates
        reads, lens = encode_reads(reads_l)
        want = naive_bwt([convert_itos(r) for r in reads_l])
        got = build_msbwt(reads, lens, engine="fused")
        assert convert_itos(got) == want, f"sorted trial {trial}"
        got2 = build_msbwt(reads, lens, sorted_insert=False, engine="fused")
        want2 = build_msbwt(reads, lens, sorted_insert=False, engine="xla")
        assert np.array_equal(got2, want2), f"chrono trial {trial}"
    # extend after a radix-2 build
    base_l = [rng.integers(1, 6, 12).astype(np.uint8) for _ in range(8)]
    br, bl = encode_reads(base_l)
    base = build_msbwt(br, bl, engine="fused")
    new_l = [rng.integers(1, 6, 9).astype(np.uint8) for _ in range(5)]
    nr, nl = encode_reads(new_l)
    got = build_msbwt(nr, nl, base=base, base_string_count=8, engine="fused")
    want = naive_bwt([convert_itos(r) for r in base_l + new_l])
    assert convert_itos(got) == want


def test_radix2_with_index(monkeypatch, rng):
    """Fused index derivation must be exact off radix-2 carries too."""
    import jax.numpy as jnp

    from msbwt_jax.ops.bcr import build_msbwt_with_index
    from msbwt_jax.ops.packed_rank import pack_index
    from msbwt_jax.ops.rank import build_occ_index

    monkeypatch.setenv("MSBWT_RADIX", "2")
    reads = rng.integers(1, 6, size=(30, 11)).astype(np.uint8)
    lengths = np.full(30, 11, np.int32)
    decoded = build_msbwt(reads, lengths, engine="fused")
    want = pack_index(build_occ_index(jnp.asarray(decoded)))
    idx, packed = build_msbwt_with_index(reads, lengths, engine="fused")
    assert np.array_equal(np.asarray(packed.table), np.asarray(want.table))


def test_wire_packed_upload_byte_identical(rng):
    """The nibble-packed host->device upload path (split-half layout) must
    be invisible: builds with the threshold forced to 0 equal the plain
    uploads, for odd and even view sizes and the extend flow."""
    from msbwt_jax.ops import bcr

    reads = [
        "".join(rng.choice(list("ACGT"), size=int(k)))
        for k in rng.integers(3, 12, size=17)
    ]
    enc, lengths = encode_reads([convert_stoi(s) for s in reads])
    want = build_msbwt(enc, lengths)
    old = bcr._WIRE_PACK_MIN_BYTES
    try:
        bcr._WIRE_PACK_MIN_BYTES = 0
        got = build_msbwt(enc, lengths)
        # extend: base upload also rides the packed path
        extra, el = encode_reads([convert_stoi("GATTACA")])
        ext = build_msbwt(extra, el, base=np.asarray(got),
                          base_string_count=len(reads))
    finally:
        bcr._WIRE_PACK_MIN_BYTES = old
    assert got.tolist() == want.tolist()
    assert convert_itos(ext) == naive_bwt(reads + ["GATTACA"])
    # raw unpack round-trip at an odd length
    flat = rng.integers(0, 6, size=1001).astype(np.uint8)
    try:
        bcr._WIRE_PACK_MIN_BYTES = 0
        up = np.asarray(bcr._upload_symbols(flat))
    finally:
        bcr._WIRE_PACK_MIN_BYTES = old
    assert up.tolist() == flat.tolist()


def test_bucket_schedule_growth_factors():
    """The schedule must cover stages [2, L+2) contiguously with chunk-
    aligned, size-sufficient, non-decreasing capacities for any growth
    factor (env MSBWT_BUCKET_GROWTH)."""
    from msbwt_jax.ops.bcr import bucket_schedule

    for growth in (1.05, 1.2, 1.3, 1.5, 2.0, 3.0, 4.0):
        for (n0, N, L, chunk) in [(0, 10, 20, 16), (37, 7, 100, 64),
                                  (0, 1000, 100, 8192), (5, 3, 8, 8)]:
            n_cap = n0 + N * (L + 1) + N
            sched = bucket_schedule(n0, N, L, n_cap, chunk, growth=growth)
            assert sched[0][0] == 2
            assert sched[-1][1] == L + 2
            prev_jb, prev_cap = 2, 0
            for ja, jb, cap in sched:
                assert ja == prev_jb and jb > ja, (growth, sched)
                assert cap % chunk == 0
                assert cap >= n0 + (jb - 1) * N, (growth, ja, jb, cap)
                assert cap >= prev_cap, "capacities must be non-decreasing"
                prev_jb, prev_cap = jb, cap


def test_bucketed_build_small_growth_matches_oracle(monkeypatch, rng):
    """A bucketed build with a small growth factor (many buckets) must stay
    oracle-exact — forced at tiny scale by patching the size gate."""
    from msbwt_jax.ops import bcr

    monkeypatch.setattr(bcr, "_BUCKET_MIN_SYMBOLS", 1)
    monkeypatch.setenv("MSBWT_BUCKET_GROWTH", "1.2")
    reads_l = [rng.integers(1, 6, int(rng.integers(3, 14))).astype(np.uint8)
               for _ in range(25)]
    reads, lens = encode_reads(reads_l)
    got = build_msbwt(reads, lens, engine="fused")
    assert convert_itos(got) == naive_bwt([convert_itos(r) for r in reads_l])


def test_bucketed_radix2_small_growth(monkeypatch, rng):
    """Radix-2 stage pairing must respect bucket boundaries for any growth
    factor (buckets shrink to even stage counts, never extend)."""
    from msbwt_jax.ops import bcr

    monkeypatch.setattr(bcr, "_BUCKET_MIN_SYMBOLS", 1)
    monkeypatch.setenv("MSBWT_BUCKET_GROWTH", "1.2")
    monkeypatch.setenv("MSBWT_RADIX", "2")
    reads_l = [rng.integers(1, 6, int(rng.integers(4, 16))).astype(np.uint8)
               for _ in range(20)]
    reads, lens = encode_reads(reads_l)
    got = build_msbwt(reads, lens, engine="fused")
    assert convert_itos(got) == naive_bwt([convert_itos(r) for r in reads_l])


def test_all_optin_levers_composed(monkeypatch, rng):
    """Every opt-in perf lever enabled at once (pair-fast stream, 60-lane
    pair rows, small bucket growth) must stay oracle-exact through the
    fused build -> indexes -> pair -> queries flow."""
    import jax.numpy as jnp

    from msbwt_jax.ops import bcr
    from msbwt_jax.ops.bcr import build_msbwt_with_index
    from msbwt_jax.ops.pair_rank import build_pair_index, count_kmers_pair
    from msbwt_jax.ops.rank import build_occ_index, count_kmers

    monkeypatch.setattr(bcr, "_BUCKET_MIN_SYMBOLS", 1)
    monkeypatch.setenv("MSBWT_BUCKET_GROWTH", "1.2")
    monkeypatch.setenv("MSBWT_PAIR_FAST", "1")
    monkeypatch.setenv("MSBWT_PAIR_ROW60", "1")
    reads_l = [rng.integers(1, 6, int(rng.integers(3, 18))).astype(np.uint8)
               for _ in range(30)]
    reads, lens = encode_reads(reads_l)
    want = naive_bwt([convert_itos(r) for r in reads_l])
    idx, packed = build_msbwt_with_index(reads, lens, engine="fused")
    got = np.asarray(idx.bwt[: idx.n])
    assert convert_itos(got) == want
    pidx = build_pair_index(idx)
    assert pidx.table2.shape[1] == 60
    kmers = rng.integers(0, 6, size=(200, 5)).astype(np.uint8)
    ref = count_kmers(build_occ_index(jnp.asarray(np.asarray(got))), kmers)
    assert np.array_equal(count_kmers_pair(pidx, kmers), ref)
