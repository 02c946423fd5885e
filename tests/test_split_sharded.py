"""Sharded split-layout capacity mode: ingestion identity + search parity
with single-chip, on the virtual CPU mesh (interpret kernels)."""

import numpy as np

from shine_tpu.io import recall_at_k
from shine_tpu.io.device_synth import device_rowkeyed_split_dataset
from shine_tpu.models.flat import SplitFlatIndex
from shine_tpu.parallel import shard_mesh
from shine_tpu.parallel.fastflat_sharded import ShardedSplitFlatIndex


def test_split_ingest_sharded_matches_single_chip():
    mesh = shard_mesh(4)
    a = device_rowkeyed_split_dataset(
        n=65536, dim=16, num_queries=32, seed=9, rchunk=4096,
        comp_dtype="int8",
    )
    b = device_rowkeyed_split_dataset(
        n=65536, dim=16, num_queries=32, seed=9, rchunk=4096,
        comp_dtype="int8", mesh=mesh,
    )
    np.testing.assert_array_equal(a.queries, b.queries)
    np.testing.assert_array_equal(
        np.asarray(a.comp_dev), np.asarray(b.comp_dev)
    )
    np.testing.assert_array_equal(
        np.asarray(a.aux_dev), np.asarray(b.aux_dev)
    )
    np.testing.assert_array_equal(a.ground_truth, b.ground_truth)


def test_sharded_split_matches_single_chip_and_recall():
    """Same ids from the 4-shard mesh search and the single-chip split
    search (both exact-regen re-rank, (dist, id) tie-break)."""
    mesh = shard_mesh(4)
    ds = device_rowkeyed_split_dataset(
        n=65536, dim=16, num_queries=48, seed=5, rchunk=4096,
        comp_dtype="int8", mesh=mesh,
    )
    sh = ShardedSplitFlatIndex.from_dataset(ds, mesh, dim=16)
    ids_sh, dd_sh = sh.search(ds.queries, 10, kb=24, batch_size=64)
    r_sh = recall_at_k(ids_sh, ds.ground_truth, 10)
    assert r_sh >= 0.9, r_sh

    single = SplitFlatIndex.from_parts(
        ds.comp_dev, ds.aux_dev, ds.n, dim=16, row_source=ds.row_source
    )
    # per-shard scan at cls=C equals the single-chip scan at the same
    # rows-per-class only in candidate membership, not exactly; compare
    # against GT instead for the single path and require parity-level
    # recall
    ids_1, _ = single.search(
        ds.queries, 10, kb=24 * 4, batch_size=64, cls=1024,
        keep2=False,
    )
    r_1 = recall_at_k(ids_1, ds.ground_truth, 10)
    assert abs(r_1 - r_sh) < 0.08, (r_1, r_sh)
    # exact-regen re-rank: distances for ground-truth hits are exact
    gt = ds.ground_truth
    hit = ids_sh[:, :1] == gt[:, :1]
    assert hit.mean() > 0.8


def test_sharded_split_prerank_trim():
    """prerank on the sharded split path: stage-1 int8 trim before the
    exact regen re-rank keeps recall at a generous margin."""
    mesh = shard_mesh(4)
    ds = device_rowkeyed_split_dataset(
        n=65536, dim=16, num_queries=48, seed=5, rchunk=4096,
        comp_dtype="int8", mesh=mesh,
    )
    sh = ShardedSplitFlatIndex.from_dataset(ds, mesh, dim=16)
    ids0, _ = sh.search(ds.queries, 10, kb=32, batch_size=64)
    ids1, dd1 = sh.search(
        ds.queries, 10, kb=32, batch_size=64, prerank=16
    )
    r0 = recall_at_k(ids0, ds.ground_truth, 10)
    r1 = recall_at_k(ids1, ds.ground_truth, 10)
    assert r1 >= r0 - 0.02, (r0, r1)
    assert np.all(np.diff(dd1, axis=1) >= -1e-5)


def test_sharded_split_bf16_mode():
    mesh = shard_mesh(2)
    ds = device_rowkeyed_split_dataset(
        n=32768, dim=16, num_queries=32, seed=7, rchunk=4096,
        comp_dtype="bf16", mesh=mesh,
    )
    assert ds.comp_dev.dtype.name == "bfloat16"
    sh = ShardedSplitFlatIndex.from_dataset(ds, mesh, dim=16)
    ids, _ = sh.search(ds.queries, 10, kb=24, batch_size=32)
    assert recall_at_k(ids, ds.ground_truth, 10) >= 0.95


def test_sharded_split_from_host_recall_and_id_map():
    """from_host packs a host base over the mesh (the CLI route):
    shuffle perm maps packed ids back to file order, recall vs exact
    ground truth holds."""
    from shine_tpu.io import synthetic_dataset

    mesh = shard_mesh(4)
    ds = synthetic_dataset(n=20000, dim=16, num_queries=64, seed=13)
    sh = ShardedSplitFlatIndex.from_host(
        ds.base, mesh, comp_dtype="int8", seed=13
    )
    assert sh.perm is not None
    ids, dd = sh.search(ds.queries, 10, kb=24, batch_size=64)
    assert ids.max() < 20000 and (ids >= -1).all()
    r = recall_at_k(ids, ds.ground_truth, 10)
    assert r >= 0.9, r


def test_from_host_packing_matches_single_chip():
    """from_host(seed) and SplitFlatIndex(seed) shuffle identically, so
    the packed tables agree row-for-row over the real rows (padding
    quanta differ: SPLIT_QUANTUM vs SPLIT_QUANTUM*S)."""
    from shine_tpu.io import synthetic_dataset
    from shine_tpu.models.flat import SplitFlatIndex

    mesh = shard_mesh(4)
    ds = synthetic_dataset(n=12000, dim=16, num_queries=8, seed=7)
    sh = ShardedSplitFlatIndex.from_host(
        ds.base, mesh, comp_dtype="int8", seed=7
    )
    single = SplitFlatIndex(
        ds.base, comp_dtype="int8", seed=7
    )
    n = ds.base.shape[0]
    np.testing.assert_array_equal(
        np.asarray(sh.comp)[:n], np.asarray(single.comp)[:n]
    )
    np.testing.assert_array_equal(
        np.asarray(sh.aux)[:, :n], np.asarray(single.aux)[:, :n]
    )
    np.testing.assert_array_equal(sh.perm, single.perm)
