"""Row-sharded exact search on the virtual CPU mesh."""

import numpy as np
import pytest

from shine_tpu.io import recall_at_k, synthetic_dataset
from shine_tpu.models.flat import FlatIndex
from shine_tpu.parallel import shard_mesh
from shine_tpu.parallel.flat_sharded import ShardedFlatIndex


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(n=7000, dim=32, num_queries=100, seed=21)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_flat_exact(ds, n_shards):
    mesh = shard_mesh(n_shards)
    idx = ShardedFlatIndex(ds.base, mesh)
    ids, dists = idx.search(ds.queries, 10, chunk=1024, use_bf16=False)
    assert recall_at_k(ids, ds.ground_truth, 10) == pytest.approx(1.0)
    assert np.all(np.diff(dists, axis=1) >= -1e-5)


def test_sharded_matches_single(ds):
    mesh = shard_mesh(4)
    sh = ShardedFlatIndex(ds.base, mesh)
    si = FlatIndex(ds.base)
    a, _ = sh.search(ds.queries, 10, chunk=1024, use_bf16=False)
    b, _ = si.search(ds.queries, 10, chunk=1024, use_bf16=False)
    np.testing.assert_array_equal(a, b)


def test_sharded_sqnorms_bitwise_match_single(ds):
    """Values that rank rows must come from ONE reduction implementation:
    host-numpy (v*v).sum(-1) rounds differently from the XLA row reduce
    at the last ulp (~72% of rows at 64k x 64), which flipped (dist, id)
    ties at the k-cutoff and broke single-vs-sharded fastbuild neighbor
    identity at 262k. Both constructors must
    use _row_sq, and the f32 searches must agree exactly."""
    mesh = shard_mesh(8)
    sh = ShardedFlatIndex(ds.base, mesh)
    si = FlatIndex(ds.base)
    n = len(ds.base)
    np.testing.assert_array_equal(
        np.asarray(sh.data.sqnorms)[:n], np.asarray(si.data.sqnorms)[:n]
    )
    a_i, a_d = sh.search(ds.base[:512], 17, chunk=1024, use_bf16=False)
    b_i, b_d = si.search(ds.base[:512], 17, chunk=4096, use_bf16=False)
    np.testing.assert_array_equal(a_i, b_i)
    np.testing.assert_array_equal(a_d, b_d)


def test_sharded_flat_ip():
    ds = synthetic_dataset(n=3000, dim=16, num_queries=50, seed=9, metric="ip")
    mesh = shard_mesh(8)
    idx = ShardedFlatIndex(ds.base, mesh, metric="ip")
    ids, _ = idx.search(ds.queries, 10, chunk=1024, use_bf16=False)
    assert recall_at_k(ids, ds.ground_truth, 10) == pytest.approx(1.0)


def test_sharded_fastflat(ds):
    from shine_tpu.parallel.fastflat_sharded import ShardedFastFlatIndex

    mesh = shard_mesh(4)
    idx = ShardedFastFlatIndex(ds.base, mesh)
    ids, dists = idx.search(ds.queries, 10, batch_size=128)
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.97
    assert np.all(np.diff(dists, axis=1) >= -1e-3)


def test_sharded_fastflat_keep2(ds):
    """keep2 candidates (class winner + runner-up) through the sharded
    merge: recall must be >= the single-slot path."""
    from shine_tpu.io import recall_at_k
    from shine_tpu.parallel import ShardedFastFlatIndex, shard_mesh

    mesh = shard_mesh(4)
    idx = ShardedFastFlatIndex(ds.base, mesh)
    a, _ = idx.search(ds.queries, 10, kb=16, cls=128, batch_size=256)
    b, _ = idx.search(ds.queries, 10, kb=16, cls=128, batch_size=256, keep2=True)
    ra = recall_at_k(a, ds.ground_truth, 10)
    rb = recall_at_k(b, ds.ground_truth, 10)
    assert rb >= ra
    assert rb > 0.9
