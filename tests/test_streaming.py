"""Streaming construction: batched extends equal one-shot builds
(the reference's load-and-extend flow at batch granularity,
ref: src/lib.rs:30-43, src/dynamic_bwt.rs:734-773)."""

import numpy as np
import pytest

from msbwt_jax.ops.bcr import build_msbwt, encode_reads
from msbwt_jax.utils.streaming import StreamingBuilder, build_msbwt_streaming


def _reads(n, seed, lmin=3, lmax=25):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 6, rng.integers(lmin, lmax)).astype(np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_streaming_equals_one_shot(sorted_insert):
    reads, lens = encode_reads(_reads(30, seed=1))
    want = build_msbwt(reads, lens, sorted_insert=sorted_insert)
    got = build_msbwt_streaming(reads, lens, batch_size=7,
                                sorted_insert=sorted_insert)
    assert np.array_equal(got, want)


def test_streaming_variable_batch_shapes():
    b = StreamingBuilder()
    all_reads = []
    for seed, n in [(2, 5), (3, 11), (4, 1), (5, 8)]:
        batch = _reads(n, seed=seed)
        all_reads += batch
        reads, lens = encode_reads(batch)
        b.add_batch(reads, lens)
    got = b.finish()
    reads, lens = encode_reads(all_reads)
    want = build_msbwt(reads, lens)
    assert np.array_equal(got, want)
    assert b.string_count == len(all_reads)


def test_streaming_empty():
    assert StreamingBuilder().finish().size == 0


def test_streaming_checkpoint_resume(tmp_path):
    path = str(tmp_path / "ck.npy")
    batches = [_reads(6, seed=s) for s in (41, 42, 43)]
    # uninterrupted
    b = StreamingBuilder()
    for batch in batches:
        b.add_batch(*encode_reads(batch))
    want = b.finish()
    # checkpoint after batch 1, restore, continue
    b2 = StreamingBuilder()
    b2.add_batch(*encode_reads(batches[0]))
    b2.checkpoint(path)
    b3 = StreamingBuilder.restore(path)
    assert b3.string_count == 6
    for batch in batches[1:]:
        b3.add_batch(*encode_reads(batch))
    assert np.array_equal(b3.finish(), want)
