"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4)."""

import jax
import numpy as np
import pytest

from msbwt_jax.models.rle_bwt import RleBWT
from msbwt_jax.ops.alphabet import convert_itos, convert_stoi
from msbwt_jax.ops.bcr import build_msbwt, encode_reads
from msbwt_jax.ops.rle import convert_to_vec
from msbwt_jax.parallel.mesh import default_mesh
from msbwt_jax.parallel.sharded_build import build_msbwt_sharded
from msbwt_jax.parallel.sharded_index import (
    build_sharded_index,
    count_kmers_sharded,
)
from msbwt_jax.utils.oracle import naive_bwt


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return default_mesh()


def _random_reads(rng, n, lmin=5, lmax=30):
    alpha = list("ACGNT")
    return ["".join(rng.choice(alpha, size=int(rng.integers(lmin, lmax))))
            for _ in range(n)]


def test_sharded_rank_matches_single(mesh, rng):
    data = _random_reads(rng, 40)
    decoded = convert_stoi(naive_bwt(data))
    sharded = build_sharded_index(decoded, mesh)
    single = RleBWT()
    single.load_vector(convert_to_vec(naive_bwt(data)))

    queries = ["ACG", "TT", "GATTACA", "N", "A"] + [s[:6] for s in data[:5]]
    K = max(len(q) for q in queries)
    kmers = np.zeros((len(queries), K), dtype=np.uint8)
    lens = np.array([len(q) for q in queries], dtype=np.int32)
    for i, q in enumerate(queries):
        kmers[i, K - len(q):] = convert_stoi(q)

    got = count_kmers_sharded(sharded, kmers, lens)
    want = single.count_kmers(kmers, lens)
    assert got.tolist() == want.tolist()


def test_sharded_index_small_bwt(mesh):
    # BWT smaller than the device count still works (shards mostly padding)
    decoded = convert_stoi(naive_bwt(["ACGT", "TGCA"]))
    sharded = build_sharded_index(decoded, mesh)
    kmers = np.array([convert_stoi("ACGT")], dtype=np.uint8)
    assert count_kmers_sharded(sharded, kmers).tolist() == [1]


def test_sharded_build_matches_naive(mesh, rng):
    data = _random_reads(rng, 50, 1, 15)
    reads, lengths = encode_reads([convert_stoi(s) for s in data])
    got = build_msbwt_sharded(reads, lengths, mesh)
    assert convert_itos(got) == naive_bwt(data)


def test_sharded_build_matches_single_device(mesh, rng):
    data = _random_reads(rng, 37, 2, 20)
    reads, lengths = encode_reads([convert_stoi(s) for s in data])
    sharded = build_msbwt_sharded(reads, lengths, mesh)
    single = build_msbwt(reads, lengths)
    assert sharded.tolist() == single.tolist()


def test_sharded_build_fewer_reads_than_devices(mesh):
    reads, lengths = encode_reads([convert_stoi(s) for s in ["ACG", "T"]])
    got = build_msbwt_sharded(reads, lengths, mesh)
    assert convert_itos(got) == naive_bwt(["ACG", "T"])


def test_sharded_hm_merge_matches_tree():
    from msbwt_jax.ops.merge import kway_merge
    from msbwt_jax.parallel.sharded_merge import sharded_hm_merge

    rng = np.random.default_rng(17)
    groups = []
    for _ in range(5):
        reads_l = [rng.integers(1, 6, rng.integers(3, 20)).astype(np.uint8)
                   for _ in range(int(rng.integers(2, 10)))]
        reads, lens = encode_reads(reads_l)
        groups.append(build_msbwt(reads, lens))
    assert np.array_equal(sharded_hm_merge(groups), kway_merge(groups))


def test_build_sharded_with_distributed_merge():
    rng = np.random.default_rng(23)
    reads_l = [rng.integers(1, 6, rng.integers(4, 30)).astype(np.uint8)
               for _ in range(40)]
    reads, lens = encode_reads(reads_l)
    want = build_msbwt(reads, lens)
    got = build_msbwt_sharded(reads, lens, merge="sharded")
    assert np.array_equal(got, want)


def test_sharded_query_wide_positions():
    """int64 ("wide") global positions — the >2^31-symbol path — must agree
    with the int32 path and the single-device engine on small data."""
    from msbwt_jax.ops.rank import build_occ_index, count_kmers
    import jax.numpy as jnp

    rng = np.random.default_rng(31)
    reads_l = [rng.integers(1, 6, 25).astype(np.uint8) for _ in range(40)]
    reads, lens = encode_reads(reads_l)
    dec = build_msbwt(reads, lens)
    kmers = np.stack([reads[i, 2:10] for i in range(24)]).astype(np.uint8)
    want = count_kmers(build_occ_index(jnp.asarray(dec)), kmers)
    wide = count_kmers_sharded(build_sharded_index(dec, force_wide=True), kmers)
    assert np.asarray(wide).dtype == np.int64
    assert np.array_equal(np.asarray(wide), np.asarray(want))


def test_shard_local_pos_past_2e31():
    """Regression (ADVICE r1): the shard base d*S must be computed in the
    position dtype — int32 ``shard_id * S`` wraps negative for d*S >= 2^31
    and silently corrupts wide-mode ranks."""
    import jax
    import jax.numpy as jnp
    from msbwt_jax.parallel.sharded_index import shard_local_pos

    S = 805_306_368  # 3*S = 2415919104 > 2^31
    with jax.enable_x64():
        pos = jnp.asarray([3 * S + 84_080_896, 0, 7 * S], dtype=jnp.int64)
        loc = shard_local_pos(pos, jnp.asarray(3, jnp.int32), S)
    assert loc.dtype == jnp.int32
    assert loc.tolist() == [84_080_896, 0, S]


def test_ragged_transport_matches_dense_and_tree():
    """The ragged-all-to-all merge formulation (simulated primitive on CPU)
    must equal the dense transport and the single-device merge tree."""
    from msbwt_jax.ops.merge import kway_merge
    from msbwt_jax.parallel.sharded_merge import sharded_hm_merge

    rng = np.random.default_rng(41)
    for trial in range(3):
        groups = []
        for _ in range(int(rng.integers(2, 9))):
            reads_l = [rng.integers(1, 6, rng.integers(2, 25)).astype(np.uint8)
                       for _ in range(int(rng.integers(1, 12)))]
            reads, lens = encode_reads(reads_l)
            groups.append(build_msbwt(reads, lens))
        want = kway_merge(groups)
        dense = sharded_hm_merge(groups, transport="dense")
        ragged = sharded_hm_merge(groups, transport="ragged")
        assert np.array_equal(dense, want)
        assert np.array_equal(ragged, want)


def test_ragged_transport_volume_is_one_over_d():
    """Per-round per-device ragged traffic == the device's own elements:
    in reconstruct every source ships exactly its len_j elements
    (sum_i C[i,j] == len_j) and in refine every block ships exactly its
    valid elements — O(n/D), not O(n)."""
    from msbwt_jax.parallel.sharded_merge import _PAD_SRC

    rng = np.random.default_rng(77)
    lens = rng.integers(5, 40, 8)
    n = int(lens.sum())
    offsets = np.concatenate([[0], np.cumsum(lens)])
    blk = -(-n // 8)
    # a random (valid) interleave assignment: position p -> source j
    inter = np.full(8 * blk, _PAD_SRC, np.int64)
    src_of = np.concatenate([np.full(l, j) for j, l in enumerate(lens)])
    rng.shuffle(src_of)
    inter[:n] = src_of
    C = np.zeros((8, 8), np.int64)  # C[block, source]
    for i in range(8):
        blk_i = inter[i * blk : (i + 1) * blk]
        for j in range(8):
            C[i, j] = np.count_nonzero(blk_i == j)
    # reconstruct: source j sends sum_i C[i, j] elements == its length
    assert C.sum(axis=0).tolist() == lens.tolist()
    # refine: block i sends its valid element count
    assert C.sum(axis=1).tolist() == [
        min(blk, max(0, n - i * blk)) for i in range(8)
    ]


def test_sharded_build_wide_merge_end_to_end():
    """Forced-wide end-to-end build on the CPU mesh: per-shard int32 builds
    composed by int64 merges must equal the single-device build (the
    chr21-scale >2^31-symbol composition, exercised on small data)."""
    from msbwt_jax.parallel.sharded_merge import sharded_hm_merge

    rng = np.random.default_rng(61)
    reads_l = [rng.integers(1, 6, rng.integers(4, 30)).astype(np.uint8)
               for _ in range(50)]
    reads, lens = encode_reads(reads_l)
    want = build_msbwt(reads, lens)
    for merge in ("tree", "sharded"):
        got = build_msbwt_sharded(reads, lens, merge=merge, force_wide=True)
        assert np.array_equal(got, want), merge
    # ragged transport in wide mode as well
    groups = [build_msbwt(*encode_reads(reads_l[i::4])) for i in range(4)]
    from msbwt_jax.ops.merge import kway_merge
    assert np.array_equal(
        sharded_hm_merge(groups, transport="ragged", force_wide=True),
        kway_merge(groups),
    )


def test_multihost_single_process_path():
    """The multi-host build path in its single-process degenerate form must
    produce the canonical MSBWT (init no-ops, stripe covers everything,
    distributed merge over the virtual mesh)."""
    from msbwt_jax.parallel.multihost import (
        build_msbwt_multihost,
        init_distributed,
        process_read_slice,
    )

    assert init_distributed() is False  # no cluster env in tests
    rng = np.random.default_rng(83)
    reads_l = [rng.integers(1, 6, rng.integers(3, 25)).astype(np.uint8)
               for _ in range(40)]
    sl = process_read_slice(len(reads_l))
    assert (sl.start, sl.stop) == (0, len(reads_l))
    reads, lens = encode_reads([reads_l[i] for i in range(sl.start, sl.stop)])
    got = build_msbwt_multihost(reads, lens)
    want = build_msbwt(reads, lens)
    assert np.array_equal(got, want)


def test_wide_composition_end_to_end(mesh, rng, tmp_path):
    """The full >2^31 ("chr21-shaped") composition as ONE flow at small
    scale: reads -> D-way sharded build -> wide (int64) ragged D-way merge
    -> sharded npy export -> reload -> wide sharded-index queries vs oracle.
    The pieces are separately tested elsewhere; this pins the composition
    (ref u64-counts contract: src/msbwt_core.rs:124)."""
    from msbwt_jax.utils.checkpoint import load_sharded, save_sharded

    data = _random_reads(rng, 120)
    want = convert_stoi(naive_bwt(data))

    reads, lengths = encode_reads([convert_stoi(s) for s in data])
    merged = build_msbwt_sharded(
        reads, lengths, mesh, merge="sharded", force_wide=True,
        transport="ragged",
    )
    assert np.array_equal(merged, want)

    out = tmp_path / "wide_ckpt"
    save_sharded(merged, str(out), n_shards=4)
    reloaded = load_sharded(str(out))
    assert np.array_equal(reloaded, want)

    # query the reloaded BWT through the wide (int64) sharded index
    idx = build_sharded_index(reloaded, mesh, force_wide=True)
    queries = [s[:5] for s in data[:20]]
    kmers = np.zeros((len(queries), 5), np.uint8)
    qlens = np.zeros(len(queries), np.int32)
    for i, q in enumerate(queries):
        enc = convert_stoi(q)
        kmers[i, : enc.size] = enc
        qlens[i] = enc.size
    got = count_kmers_sharded(idx, kmers, qlens)
    for i, q in enumerate(queries):
        # oracle: occurrences of q as a substring of the records
        cnt = sum(s.count(q) for s in [r + "$" for r in data])
        assert got[i] == cnt, (q, got[i], cnt)
