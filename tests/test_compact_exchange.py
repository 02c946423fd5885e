"""Compact bucketed-all_to_all owner RPC for the sharded search
(parallel/sharded.py:_owner_rpc) — the interconnect-lean replacement for the dense
all_gather/psum_scatter exchange. Must be bit-identical to the dense path
(nothing is dropped: overflowing buckets are served in further rounds),
the moral equivalent of the reference's doorbell-batched one-sided READs
(rdma_reads.hh:9-38) where only requested rows cross the wire."""

import numpy as np
import pytest

from shine_tpu.config import HNSWParams, SearchParams
from shine_tpu.graph import build_graph
from shine_tpu.parallel import ShardedIndex, shard_mesh


@pytest.fixture(scope="module")
def ds():
    from shine_tpu.io import synthetic_dataset

    return synthetic_dataset(n=4000, dim=32, num_queries=128, seed=11)


@pytest.fixture(scope="module")
def graph(ds):
    return build_graph(ds.base, HNSWParams(M=16, ef_construction=100), threads=8)


def test_compact_matches_dense(ds, graph):
    """Distances are ~1e-4-close, not bit-equal (the compact payload's
    (lanes, d) dot lowers with a different d-reduction order than the
    dense batched GEMM); ids must still match exactly here — near-ties
    that could flip under 1e-4 noise don't occur in this fixture."""
    mesh = shard_mesh(8)
    idx = ShardedIndex(graph, mesh)
    a_i, a_d = idx.search(ds.queries, SearchParams(k=10, ef=64), batch_size=64)
    dense_bytes = idx.ici_bytes
    b_i, b_d = idx.search(
        ds.queries, SearchParams(k=10, ef=64, exchange="compact"), batch_size=64
    )
    compact_bytes = idx.ici_bytes - dense_bytes
    np.testing.assert_array_equal(a_i, b_i)
    np.testing.assert_allclose(a_d, b_d, rtol=1e-4, atol=1e-3)
    assert idx.ici_lanes > 0  # compact path actually shipped lanes
    assert idx.rpc_rounds > 0
    # the whole point: O(B*K) lanes instead of O(S*B*K) — at S=8 the
    # compact exchange should cut wire bytes by >2x even with 2x slack
    assert dense_bytes > 0 and compact_bytes > 0
    assert compact_bytes < dense_bytes / 2, (compact_bytes, dense_bytes)


def test_compact_overflow_rounds_exact(ds, graph):
    """A starved bucket (slack 0.1) forces multi-round serving; results must
    still be identical — the overflow loop re-queues, never drops."""
    mesh = shard_mesh(4)
    idx = ShardedIndex(graph, mesh)
    a_i, a_d = idx.search(ds.queries, SearchParams(k=10, ef=48), batch_size=64)
    rounds0 = idx.rpc_rounds
    b_i, b_d = idx.search(
        ds.queries,
        SearchParams(k=10, ef=48, exchange="compact", exchange_slack=0.1),
        batch_size=64,
    )
    np.testing.assert_array_equal(a_i, b_i)
    np.testing.assert_allclose(a_d, b_d, rtol=1e-4, atol=1e-3)
    c_i, _ = idx.search(
        ds.queries, SearchParams(k=10, ef=48, exchange="compact"), batch_size=64
    )
    np.testing.assert_array_equal(a_i, c_i)
    assert idx.rpc_rounds > rounds0  # starved buckets took extra rounds


def test_compact_with_cache_matches(ds, graph):
    """Replica hits never enter the RPC (cold lanes only), and results are
    unchanged; the compact path must ship fewer lanes with a cache than
    without one (hits stay local)."""
    sp = SearchParams(k=10, ef=64, exchange="compact")
    mesh = shard_mesh(4)
    plain = ShardedIndex(graph, mesh)
    cached = ShardedIndex(graph, mesh, cache_capacity=1024)
    a, da = plain.search(ds.queries, sp, batch_size=64)
    b, db = cached.search(ds.queries, sp, batch_size=64)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(da, db, rtol=1e-4, atol=1e-3)
    assert cached.cache_hits > 0
    assert cached.ici_lanes < plain.ici_lanes


def test_compact_with_adaptive_cache(ds, graph):
    """count_access variant (cache adaptation loop) composes with the
    compact exchange; refresh keeps results identical."""
    sp = SearchParams(k=10, ef=64, exchange="compact")
    mesh = shard_mesh(4)
    idx = ShardedIndex(
        graph, mesh, cache_capacity=512, adaptive_cache=True, refresh_every=1
    )
    ref = ShardedIndex(graph, mesh)
    a, _ = ref.search(ds.queries, sp, batch_size=64)
    b, _ = idx.search(ds.queries, sp, batch_size=64)
    np.testing.assert_array_equal(a, b)
    assert idx.refreshes >= 1
    c, _ = idx.search(ds.queries, sp, batch_size=64)  # post-refresh replica
    np.testing.assert_array_equal(a, c)


def test_adaptive_slack_beats_static(ds, graph):
    """The slack ladder (SlackController) under a skewed, affinity-routed
    workload: identical results, measured wire bytes BELOW the static
    slack=2 baseline, and no round blowup (VERDICT r2 #4 — occupancy
    wins must convert to bytes)."""
    from shine_tpu.io.skew import skewed_workload

    _, timed, _ = skewed_workload(
        ds.queries, total=512, alpha=1.25, warmup=0, seed=3
    )
    mesh = shard_mesh(4)
    sp_static = SearchParams(k=10, ef=48, exchange="compact")
    sp_adapt = SearchParams(
        k=10, ef=48, exchange="compact", adaptive_slack=True
    )
    a = ShardedIndex(graph, mesh, routing=True)
    b = ShardedIndex(graph, mesh, routing=True)
    ai, _ = a.search(timed, sp_static, batch_size=32)
    bi, _ = b.search(timed, sp_adapt, batch_size=32)
    np.testing.assert_array_equal(ai, bi)
    # all three ladder levels were probed on live batches
    assert b._slack_ctl is not None and len(b._slack_ctl.samples) == 3
    assert b.ici_bytes < a.ici_bytes, (b.ici_bytes, a.ici_bytes)
    assert b.rpc_rounds <= 2 * a.rpc_rounds, (b.rpc_rounds, a.rpc_rounds)
