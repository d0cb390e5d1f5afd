"""Doctest layer — the reference uses runnable examples on nearly every
public fn as a second test surface (SURVEY.md §4, e.g. src/msbwt_core.rs:104,
src/lib.rs:20-43); this mirrors that for the host-side API modules."""

import doctest

import pytest

import msbwt_jax.apps.correct as app_correct
import msbwt_jax.models.core as core
import msbwt_jax.models.dynamic as dynamic
import msbwt_jax.models.rle_bwt as rle_bwt
import msbwt_jax.ops.alphabet as alphabet
import msbwt_jax.ops.bcr as bcr
import msbwt_jax.ops.extract as extract
import msbwt_jax.ops.merge as merge
import msbwt_jax.ops.packed_rank as packed_rank
import msbwt_jax.ops.pair_rank as pair_rank
import msbwt_jax.ops.rank as rank
import msbwt_jax.ops.rle as rle
import msbwt_jax.parallel.doubling_merge as doubling_merge
import msbwt_jax.parallel.partitioned as partitioned
import msbwt_jax.parallel.sharded_index as sharded_index
import msbwt_jax.parallel.sharded_merge as sharded_merge
import msbwt_jax.utils.checkpoint as checkpoint
import msbwt_jax.utils.checks as checks
import msbwt_jax.utils.fastx as fastx
import msbwt_jax.utils.npy as npy
import msbwt_jax.utils.oracle as oracle
import msbwt_jax.utils.profiling as profiling
import msbwt_jax.utils.streaming as streaming


@pytest.mark.parametrize(
    "mod",
    [alphabet, rle, core, dynamic, rle_bwt, npy, oracle, merge, packed_rank,
     pair_rank, sharded_index, checkpoint, streaming, bcr, rank, partitioned,
     sharded_merge, app_correct, fastx, extract, doubling_merge, checks,
     profiling],
    ids=lambda m: m.__name__,
)
def test_doctests(mod):
    result = doctest.testmod(mod, raise_on_error=False)
    assert result.attempted > 0, f"no doctests collected in {mod.__name__}"
    assert result.failed == 0
