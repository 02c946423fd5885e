"""Sharded capacity mode (the 100M-class configuration) + row-keyed
exact regeneration.

Row-keyed datasets derive every base row from fold_in(key, global_id)
(io/device_synth.py:regen_rows), so (1) sharded streaming ingestion is
bit-identical to single-chip, and (2) capacity-mode search can re-rank
candidates against EXACT f32 rows regenerated in-jit — no resident base
anywhere (reference envelope: 100M rows across MNs,
/root/reference/src/memory_node.hh:112-125)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shine_tpu.io import recall_at_k
from shine_tpu.io.device_synth import (
    device_rowkeyed_ext_dataset,
    regen_rows,
)
from shine_tpu.models.flat import FastFlatIndex
from shine_tpu.parallel import shard_mesh
from shine_tpu.parallel.fastflat_sharded import ShardedFastFlatIndex


def test_rowkeyed_sharded_ingest_matches_single_chip():
    """The same dataset built single-chip and mesh-sharded must be
    bit-identical: ext table, ground truth, queries (rows are pure
    functions of their global id, not of the ingestion layout)."""
    mesh = shard_mesh(4)
    a = device_rowkeyed_ext_dataset(
        n=16384, dim=16, num_queries=32, seed=9, rchunk=2048
    )
    b = device_rowkeyed_ext_dataset(
        n=16384, dim=16, num_queries=32, seed=9, rchunk=2048, mesh=mesh
    )
    np.testing.assert_array_equal(a.queries, b.queries)
    np.testing.assert_array_equal(
        np.asarray(a.ext_dev), np.asarray(b.ext_dev)
    )
    np.testing.assert_array_equal(a.ground_truth, b.ground_truth)


def test_regen_rerank_matches_resident_rows():
    """regen_rerank_topk must equal rerank_topk run against the
    materialized rows — same ids, same f32 distances."""
    from shine_tpu.ops.distance import regen_rerank_topk, rerank_topk

    key = jax.random.PRNGKey(4)
    centers = jax.random.normal(jax.random.PRNGKey(1), (8, 12)) * 4.0
    n = 4096
    rows = regen_rows(key, centers, jnp.arange(n, dtype=jnp.int32))
    sq = jnp.sum(rows * rows, axis=1)
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(size=(16, 12)).astype(np.float32))
    cand = jnp.asarray(
        rng.integers(0, n, size=(16, 64)).astype(np.int32)
    )
    d_res, i_res = rerank_topk(rows, sq, q, cand, 10, 0)
    d_rg, i_rg = regen_rerank_topk(key, centers, q, cand, 10, 0)
    np.testing.assert_array_equal(np.asarray(i_res), np.asarray(i_rg))
    np.testing.assert_allclose(
        np.asarray(d_res), np.asarray(d_rg), rtol=1e-5, atol=1e-4
    )


def test_capacity_exact_regen_recall():
    """from_ext + row_source: exact f32 re-rank without a resident base.
    Recall must be at least the bf16-ext re-rank's and the returned
    distances must be exact (match the GT distance for GT hits)."""
    ds = device_rowkeyed_ext_dataset(
        n=8192, dim=16, num_queries=64, seed=3, rchunk=2048
    )
    bf = FastFlatIndex.from_ext(ds.ext_dev, ds.n, dim=16)
    ids_bf, _ = bf.search(ds.queries, 10, kb=32, batch_size=64)
    ex = FastFlatIndex.from_ext(
        ds.ext_dev, ds.n, dim=16, row_source=ds.row_source
    )
    ids_ex, dists_ex = ex.search(ds.queries, 10, kb=32, batch_size=64)
    r_bf = recall_at_k(ids_bf, ds.ground_truth, 10)
    r_ex = recall_at_k(ids_ex, ds.ground_truth, 10)
    assert r_ex >= r_bf - 1e-9
    assert r_ex > 0.95, (r_ex, r_bf)
    assert np.all(np.diff(dists_ex, axis=1) >= -1e-5)


def test_sharded_capacity_matches_single_chip():
    """ShardedFastFlatIndex.from_ext over the mesh vs the single-chip
    capacity index on the identical ext table: both exact-regen paths,
    (near-)identical results and healthy recall."""
    mesh = shard_mesh(4)
    ds = device_rowkeyed_ext_dataset(
        n=16384, dim=16, num_queries=64, seed=5, rchunk=2048, mesh=mesh
    )
    cap = ShardedFastFlatIndex.from_ext(
        ds.ext_dev, ds.n, mesh, dim=16, row_source=ds.row_source
    )
    assert cap.dim == 16 and cap.rows == 4096
    sids, sdists = cap.search(ds.queries, 10, kb=32, batch_size=64)
    single = FastFlatIndex.from_ext(
        jnp.asarray(np.asarray(ds.ext_dev)), ds.n, dim=16,
        row_source=ds.row_source,
    )
    fids, _ = single.search(ds.queries, 10, kb=32, batch_size=64)
    assert recall_at_k(sids, ds.ground_truth, 10) > 0.95
    assert recall_at_k(fids, ds.ground_truth, 10) > 0.95
    # both re-rank exactly, so wherever both scans kept the true rows the
    # outputs agree; sharded scans keep kb per SHARD so it can only see
    # more candidates than single-chip
    assert (sids == fids).mean() > 0.9
    assert np.all(np.diff(sdists, axis=1) >= -1e-5)


def test_sharded_capacity_bf16_rerank_path():
    """The ext-only sharded path without a row source (real data with no
    regenerable base) re-ranks from bf16 ext rows per shard."""
    mesh = shard_mesh(4)
    ds = device_rowkeyed_ext_dataset(
        n=16384, dim=16, num_queries=64, seed=7, rchunk=2048, mesh=mesh
    )
    cap = ShardedFastFlatIndex.from_ext(ds.ext_dev, ds.n, mesh, dim=16)
    ids, dists = cap.search(ds.queries, 10, kb=32, batch_size=64)
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.9
    assert np.all(np.diff(dists, axis=1) >= -1e-2)


def test_sharded_capacity_prerank_trim():
    """prerank>0 (stage-1 bf16 trim before the exact regen re-rank)
    keeps recall within noise of the untrimmed search on the sharded
    capacity path — at a generous margin the true rows survive stage 1,
    so the exact stage returns the same ids."""
    mesh = shard_mesh(4)
    ds = device_rowkeyed_ext_dataset(
        n=16384, dim=16, num_queries=64, seed=5, rchunk=2048, mesh=mesh
    )
    cap = ShardedFastFlatIndex.from_ext(
        ds.ext_dev, ds.n, mesh, dim=16, row_source=ds.row_source
    )
    ids0, _ = cap.search(ds.queries, 10, kb=32, batch_size=64)
    ids1, dd1 = cap.search(
        ds.queries, 10, kb=32, batch_size=64, prerank=16
    )
    r0 = recall_at_k(ids0, ds.ground_truth, 10)
    r1 = recall_at_k(ids1, ds.ground_truth, 10)
    assert r1 >= r0 - 0.02, (r0, r1)
    assert np.all(np.diff(dd1, axis=1) >= -1e-5)
    # exact-base sharded path too (f32 rows resident per shard)
    base = np.asarray(
        regen_rows(
            ds.row_source[0], ds.row_source[1],
            jnp.arange(ds.n, dtype=jnp.int32),
        )
    )
    full = ShardedFastFlatIndex(base, mesh, shuffle=False)
    fids0, _ = full.search(ds.queries, 10, kb=32, batch_size=64)
    fids1, _ = full.search(
        ds.queries, 10, kb=32, batch_size=64, prerank=16
    )
    f0 = recall_at_k(fids0, ds.ground_truth, 10)
    f1 = recall_at_k(fids1, ds.ground_truth, 10)
    assert f1 >= f0 - 0.02, (f0, f1)


def test_rowkeyed_mesh_rounds_to_shard_quantum():
    """mesh ingestion must round n so every shard's slice is a multiple
    of the 4096 scan quantum (from_ext asserts it)."""
    mesh = shard_mesh(8)
    ds = device_rowkeyed_ext_dataset(
        n=4096 * 6, dim=8, num_queries=16, seed=1, rchunk=1024, mesh=mesh
    )
    assert ds.n % (4096 * 8) == 0
    cap = ShardedFastFlatIndex.from_ext(ds.ext_dev, ds.n, mesh, dim=8)
    ids, _ = cap.search(ds.queries, 5, kb=16, batch_size=16)
    assert recall_at_k(ids, ds.ground_truth, 5) > 0.9
