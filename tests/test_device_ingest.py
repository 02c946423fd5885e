"""Device-resident ingestion: dataset generation, ext-table packing, and
IVF layout built without the base ever visiting the host (the 10M-row
path; the reference's NFS + RDMA read path is io/read_data.hh)."""

import jax.numpy as jnp
import numpy as np
import pytest

from shine_tpu.io import recall_at_k
from shine_tpu.io.device_synth import device_synthetic_dataset
from shine_tpu.models.flat import FastFlatIndex, FlatIndex
from shine_tpu.ops.packing import ext_width, pack_ext_device
from shine_tpu.models.ivf import IVFIndex


@pytest.fixture(scope="module")
def dds():
    return device_synthetic_dataset(n=8192, dim=32, num_queries=128, seed=3)


def test_device_gt_matches_host_flat(dds):
    """On-device exact GT == host-built exact flat scan."""
    base_np = np.asarray(dds.base_dev)
    host = FlatIndex(base_np)
    ids, _ = host.search(dds.queries, 10, use_bf16=False)
    assert recall_at_k(ids, dds.ground_truth, 10) == pytest.approx(1.0)


def test_flat_from_device_exact(dds):
    idx = FlatIndex.from_device(dds.base_dev, with_bf16=False)
    ids, _ = idx.search(dds.queries, 10, use_bf16=False)
    assert recall_at_k(ids, dds.ground_truth, 10) == pytest.approx(1.0)


def test_pack_ext_device_matches_host(dds):
    """The on-device bf16 ext packing must match the host packer: vector
    columns bit-for-bit; the residual-encoded norm pair (cols d, d+1) as
    a decoded SUM — host numpy and device XLA reduce ||v||^2 in different
    f32 orders, so each encodes its own last-bit-accurate value and the
    raw residuals legitimately differ."""
    from shine_tpu.config import METRIC_L2
    from shine_tpu.ops.packing import pack_ext_table

    base_np = np.asarray(dds.base_dev)
    n, d = base_np.shape
    dp = ext_width(d)
    host_ext = jnp.asarray(
        pack_ext_table(base_np, METRIC_L2, n), dtype=jnp.bfloat16
    )
    dev_ext = pack_ext_device(dds.base_dev, metric=METRIC_L2, dp=dp)
    assert dev_ext.shape == host_ext.shape
    he = np.asarray(host_ext, np.float32)
    de = np.asarray(dev_ext, np.float32)
    np.testing.assert_array_equal(de[:, :d], he[:, :d])
    np.testing.assert_array_equal(de[:, d + 2 :], he[:, d + 2 :])
    sq = (base_np.astype(np.float32) ** 2).sum(-1)
    np.testing.assert_allclose(
        de[:, d] + de[:, d + 1], he[:, d] + he[:, d + 1],
        atol=np.maximum(np.abs(sq), 1.0).max() * 2 ** -15,
    )


def test_fastflat_from_device_requires_quantum(dds):
    with pytest.raises(ValueError):
        FastFlatIndex.from_device(dds.base_dev[:1000])


def test_fastflat_from_device_shuffle_perm(dds):
    idx = FastFlatIndex.from_device(dds.base_dev, shuffle=True, seed=5)
    assert idx.perm is not None and len(idx.perm) == dds.n
    assert sorted(idx.perm.tolist()) == list(range(dds.n))
    # shuffled vectors match base[perm]
    np.testing.assert_array_equal(
        np.asarray(idx.vectors[:64]), np.asarray(dds.base_dev)[idx.perm[:64]]
    )


def test_fastflat_from_device_auto_shuffle(dds, monkeypatch):
    """shuffle=None (the default) auto-enables the on-device ingest
    permutation when its transient fits the device's memory beside the
    index (unshuffled ingest loses ~0.008 recall at 1M via same-class
    decoy correlation), stays off when it does not, and search() remaps
    ids back to original space."""
    from shine_tpu.models.flat import fastflat_row_bytes

    idx = FastFlatIndex.from_device(dds.base_dev)
    assert idx.perm is not None  # 8192 rows << the stated device bytes
    ids, _ = idx.search(dds.queries, 10, kb=32)
    assert recall_at_k(ids, dds.ground_truth, 10) > 0.97

    # a device that holds the index but not the extra f32 copy
    n, d = dds.base_dev.shape
    monkeypatch.setenv("SHINE_HBM_BYTES", str(n * fastflat_row_bytes(d)))
    idx2 = FastFlatIndex.from_device(dds.base_dev)
    assert idx2.perm is None


def test_ivf_from_device_recall(dds):
    idx = IVFIndex.from_device(
        dds.base_dev, num_clusters=64, train_size=8192, iters=15, seed=7,
        fill_chunk=16,
    )
    ids, _ = idx.search(dds.queries, 10, probes=8)
    assert recall_at_k(ids, dds.ground_truth, 10) > 0.9
    # lossless partition
    bids = np.asarray(idx.data.block_ids)
    real = bids[bids >= 0]
    assert sorted(real.tolist()) == list(range(dds.n))


def test_ivf_from_device_routed(dds):
    idx = IVFIndex.from_device(
        dds.base_dev, num_clusters=64, train_size=8192, iters=15, seed=7,
        fill_chunk=16,
    )
    ids, _, stats = idx.search_routed(
        dds.queries, 10, probes=8, shared=48, tile=32, with_stats=True
    )
    assert recall_at_k(ids, dds.ground_truth, 10) > 0.9
    assert stats["probe_coverage"] > 0.8


def test_streaming_ext_dataset_and_capacity_mode():
    """Streaming ingestion (device_synthetic_ext_dataset) + ext-only
    FastFlatIndex (from_ext, bf16 re-rank): the f32 base never exists as
    a whole array, yet search recall vs the exactly-folded GT holds."""
    from shine_tpu.io.device_synth import device_synthetic_ext_dataset
    from shine_tpu.models.flat import FastFlatIndex
    from shine_tpu.io import recall_at_k

    ds = device_synthetic_ext_dataset(
        n=8192, dim=16, num_queries=64, seed=3, rchunk=4096
    )
    assert ds.ext_dev.shape[0] == 8192
    idx = FastFlatIndex.from_ext(ds.ext_dev, ds.n, dim=16)
    assert idx.dim == 16 and idx.dp == ds.ext_dev.shape[1]
    ids, dists = idx.search(ds.queries, 10, kb=32, batch_size=64)
    r = recall_at_k(ids, ds.ground_truth, 10)
    assert r > 0.9, r
    assert np.all(np.diff(dists, axis=1) >= -1e-2)


def test_rerank_topk_ext_matches_exact():
    """ext-based re-rank distances track the exact f32 distances within
    bf16 row-storage tolerance."""
    import jax.numpy as jnp

    from shine_tpu.ops.distance import rerank_topk, rerank_topk_ext
    from shine_tpu.ops.packing import pack_ext_table

    rng = np.random.default_rng(9)
    base = rng.normal(size=(500, 24)).astype(np.float32)
    q = rng.normal(size=(8, 24)).astype(np.float32)
    cand = np.tile(np.arange(64, dtype=np.int32), (8, 1))
    ext = jnp.asarray(pack_ext_table(base, 0, 512), jnp.bfloat16)
    sq = jnp.asarray((base * base).sum(-1))
    d_exact, i_exact = rerank_topk(
        jnp.asarray(base), sq, jnp.asarray(q), jnp.asarray(cand), 10, 0
    )
    d_ext, i_ext = rerank_topk_ext(ext, jnp.asarray(q), jnp.asarray(cand), 10, 0)
    np.testing.assert_allclose(
        np.asarray(d_ext), np.asarray(d_exact), rtol=0.02, atol=0.15
    )
    # top-1 should essentially always agree; top-10 sets mostly
    assert (np.asarray(i_ext)[:, 0] == np.asarray(i_exact)[:, 0]).mean() >= 0.8


def test_streaming_eps_recall_consistency():
    """The regenerated chunks must reproduce the folded GT: gt rows'
    exact distances pass their own threshold (eps-recall of gt vs gt is
    1.0), and random wrong ids score lower."""
    from shine_tpu.io.device_synth import (
        device_synthetic_ext_dataset,
        streaming_eps_recall,
    )

    ds = device_synthetic_ext_dataset(
        n=8192, dim=16, num_queries=32, seed=5, rchunk=2048
    )
    assert streaming_eps_recall(ds, ds.ground_truth, 10) == 1.0
    rng = np.random.default_rng(0)
    junk = rng.integers(0, 8192, size=(32, 10)).astype(np.int32)
    assert streaming_eps_recall(ds, junk, 10) < 0.5
