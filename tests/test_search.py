"""End-to-end single-device tests: native build + batched search vs the
brute-force oracle and the native host search (SURVEY.md §4)."""

import numpy as np
import pytest

from shine_tpu.config import HNSWParams, SearchParams
from shine_tpu.graph import build_graph, host_search
from shine_tpu.io import brute_force_knn, recall_at_k, synthetic_dataset
from shine_tpu.models import HNSWIndex


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(n=5000, dim=32, num_queries=100, seed=7)


@pytest.fixture(scope="module")
def graph(ds):
    g = build_graph(ds.base, HNSWParams(M=16, ef_construction=100), threads=8)
    g.validate()
    return g


def test_host_search_recall(ds, graph):
    ids, dists = host_search(graph, ds.queries, 10, 64)
    r = recall_at_k(ids, ds.ground_truth, 10)
    assert r > 0.95, r
    assert np.all(np.diff(dists, axis=1) >= 0)


def test_batched_search_recall(ds, graph):
    idx = HNSWIndex(graph)
    ids, dists = idx.search(ds.queries, SearchParams(k=10, ef=64), batch_size=64)
    r = recall_at_k(ids, ds.ground_truth, 10)
    assert r > 0.95, r
    assert np.all(np.diff(dists, axis=1) >= -1e-5)
    assert ids.min() >= 0


def test_batched_matches_host_closely(ds, graph):
    """The fixed-width beam is the reference search with the candidate queue
    truncated to the top-ef set; at ef >> k results should agree with the
    host oracle almost everywhere."""
    idx = HNSWIndex(graph)
    h_ids, _ = host_search(graph, ds.queries, 10, 128)
    t_ids, _ = idx.search(ds.queries, SearchParams(k=10, ef=128), batch_size=128)
    overlap = recall_at_k(t_ids, h_ids, 10)
    assert overlap > 0.97, overlap


def test_search_ip_metric():
    ds = synthetic_dataset(n=3000, dim=24, num_queries=64, seed=3, metric="ip")
    g = build_graph(ds.base, HNSWParams(M=16, ef_construction=100, metric="ip"))
    idx = HNSWIndex(g)
    ids, _ = idx.search(ds.queries, SearchParams(k=10, ef=64), batch_size=64)
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.93


def test_tail_batch_padding(ds, graph):
    idx = HNSWIndex(graph)
    ids_a, _ = idx.search(ds.queries[:70], SearchParams(k=5, ef=32), batch_size=64)
    ids_b, _ = idx.search(ds.queries[:70], SearchParams(k=5, ef=32), batch_size=128)
    np.testing.assert_array_equal(ids_a, ids_b)


def test_exactness_on_tiny_graph():
    """With ef >= n the beam search must return the exact top-k. One
    build thread: a multi-threaded build is nondeterministic, and some of
    its 200-node graphs leave a few nodes unreachable from the entry."""
    ds = synthetic_dataset(n=200, dim=8, num_queries=32, seed=1)
    g = build_graph(ds.base, HNSWParams(M=8, ef_construction=64), threads=1)
    idx = HNSWIndex(g)
    ids, dists = idx.search(ds.queries, SearchParams(k=10, ef=256), batch_size=32)
    gt_ids, gt_dists = brute_force_knn(ds.base, ds.queries, 10)
    assert recall_at_k(ids, gt_ids, 10) == pytest.approx(1.0)
    np.testing.assert_allclose(dists, gt_dists, rtol=5e-3, atol=5e-2)


def test_build_determinism(ds):
    g1 = build_graph(ds.base[:2000], HNSWParams(M=8, ef_construction=50), threads=1)
    g2 = build_graph(ds.base[:2000], HNSWParams(M=8, ef_construction=50), threads=1)
    np.testing.assert_array_equal(g1.levels, g2.levels)
    np.testing.assert_array_equal(g1.neighbors0, g2.neighbors0)
    assert g1.entry_point == g2.entry_point


def test_level_distribution(graph):
    """Geometric level draw with m_L = 1/ln(M): P(level >= 1) ~ 1/M."""
    frac = (graph.levels >= 1).mean()
    M = graph.params.M
    assert 0.3 / M < frac < 3.0 / M


def test_high_dim_gist_class():
    """960-d vectors (GIST1M class, BASELINE.md): shapes must stay valid
    through the fused (d+1)-column gather and the flat scan."""
    from shine_tpu.models.flat import FlatIndex

    ds = synthetic_dataset(n=1200, dim=960, num_queries=32, seed=15)
    g = build_graph(ds.base, HNSWParams(M=8, ef_construction=40))
    idx = HNSWIndex(g)
    ids, _ = idx.search(ds.queries, SearchParams(k=10, ef=64), batch_size=32)
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.9
    fl = FlatIndex(ds.base)
    fids, _ = fl.search(ds.queries, 10, chunk=1024, use_bf16=True)
    assert recall_at_k(fids, ds.ground_truth, 10) > 0.99


def test_dataset_registry():
    from shine_tpu.io.datasets import dataset_defaults

    assert dataset_defaults("SIFT1M")["ef_search"] == 100
    assert dataset_defaults("tti10m")["metric"] == "ip"
    import pytest as _pytest

    with _pytest.raises(KeyError):
        dataset_defaults("nope")


def test_exact_distance_counter(ds, graph):
    """last_dists counts the candidate lanes actually scored — strictly
    positive, and strictly below the old hops*M_max0 estimate (which
    charged masked/dedup lanes too; reference counts per computation,
    statistics.hh:152-158)."""
    from shine_tpu.config import SearchParams
    from shine_tpu.models import HNSWIndex

    idx = HNSWIndex(graph)
    idx.search(ds.queries[:64], SearchParams(k=10, ef=48), batch_size=64)
    assert idx.last_hops > 0
    assert 0 < idx.last_dists < idx.last_hops * graph.params.M_max0


def test_chunked_dense_entry_matches_oneshot(ds, graph):
    """Above ENTRY_UCHUNK upper vertices the dense entry stage streams
    chunks with a running top-m; forcing the chunked path on a small
    graph must reproduce the one-shot results exactly."""
    from shine_tpu.config import SearchParams
    from shine_tpu.models import hnsw as hnsw_mod
    from shine_tpu.models.hnsw import HNSWIndex

    idx = HNSWIndex(graph)
    sp = SearchParams(k=10, ef=48)
    a, da = idx.search(ds.queries[:64], sp, batch_size=64)
    old = hnsw_mod.ENTRY_UCHUNK
    try:
        hnsw_mod.ENTRY_UCHUNK = 64  # much smaller than U -> chunked sweep
        # the constant isn't part of the jit cache key — force a retrace
        hnsw_mod.batched_search.clear_cache()
        idx2 = HNSWIndex(graph)
        b, db = idx2.search(ds.queries[:64], sp, batch_size=64)
    finally:
        hnsw_mod.ENTRY_UCHUNK = old
        hnsw_mod.batched_search.clear_cache()
    np.testing.assert_array_equal(a, b)
    # seed distances come from the chunked matmul's different reduction
    # grouping (~1e-4 float noise); ids must still match exactly
    np.testing.assert_allclose(da, db, rtol=1e-4, atol=1e-3)


def test_clamped_tail_chunk_no_duplicate_seeds(ds, graph):
    """Regression for the clamped-tail duplicate-seed hazard
    (models/hnsw.py entry_chunk): when U % UCHUNK != 0 the last chunk's
    window is clamped to [U-UCHUNK, U) and re-covers ids earlier chunks
    already scored; without the idx >= lo mask a duplicate can DISPLACE
    a genuine m-th seed from the running top-m. Pick UCHUNK just over
    U/2 so chunk 2 overlaps chunk 1 almost entirely, and entry_seeds
    near UCHUNK so any displacement lands inside the kept window."""
    from shine_tpu.config import SearchParams
    from shine_tpu.models import hnsw as hnsw_mod
    from shine_tpu.models.hnsw import HNSWIndex

    U = int(np.sum(graph.levels > 0))  # upper vertices (GraphSoA invariant)
    assert U >= 8, "fixture graph too small for the overlap scenario"
    m = min(U, 32)
    sp = SearchParams(k=10, ef=48, entry_seeds=m)
    idx = HNSWIndex(graph)
    a, da = idx.search(ds.queries[:64], sp, batch_size=64)

    old = hnsw_mod.ENTRY_UCHUNK
    try:
        # two chunks, second clamped: lo = UCHUNK > U - UCHUNK = off
        hnsw_mod.ENTRY_UCHUNK = U // 2 + 3
        hnsw_mod.batched_search.clear_cache()
        b, db = idx.search(ds.queries[:64], sp, batch_size=64)
    finally:
        hnsw_mod.ENTRY_UCHUNK = old
        hnsw_mod.batched_search.clear_cache()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(da, db, rtol=1e-4, atol=1e-3)


def test_quantized_row_serving(ds, graph):
    """One built graph serves at f32/bf16/int8 row storage (quantized at
    upload, models/hnsw.py:device_graph): traversal is gather-bound, so
    narrower rows halve bytes; recall must stay within the storage-noise
    envelope of f32 serving."""
    sp = SearchParams(k=10, ef=64)
    base_ids, base_d = HNSWIndex(graph).search(ds.queries, sp, batch_size=64)
    r0 = recall_at_k(base_ids, ds.ground_truth, 10)
    for rows, tol in (("bf16", 0.02), ("int8", 0.04)):
        idx = HNSWIndex(graph, rows=rows)
        assert idx.device.vectors_ext.dtype.name == (
            "bfloat16" if rows == "bf16" else "int8"
        )
        ids, dd = idx.search(ds.queries, sp, batch_size=64)
        r = recall_at_k(ids, ds.ground_truth, 10)
        assert r >= r0 - tol, (rows, r0, r)
        # distances are to the quantized rows: close to exact, not equal
        same = ids == base_ids
        np.testing.assert_allclose(
            dd[same], base_d[same], rtol=0.05, atol=0.5
        )


def test_term_k_early_exit(ds, graph):
    """term="k" (top-k-settled early exit) must cut expansion work
    substantially while staying within a hair of the reference ef
    termination rule's recall (the lockstep while_loop otherwise runs to
    the laggard query's full-ef convergence)."""
    from shine_tpu.io import recall_at_k

    idx = HNSWIndex(graph)
    sp_ef = SearchParams(k=10, ef=96, term="ef")
    sp_k = SearchParams(k=10, ef=96, term="k")
    ids_ef, _ = idx.search(ds.queries, sp_ef, batch_size=100)
    hops_ef = idx.last_hops
    ids_k, _ = idx.search(ds.queries, sp_k, batch_size=100)
    hops_k = idx.last_hops
    r_ef = recall_at_k(ids_ef, ds.ground_truth, 10)
    r_k = recall_at_k(ids_k, ds.ground_truth, 10)
    assert hops_k < 0.7 * hops_ef, (hops_k, hops_ef)
    assert r_k >= r_ef - 0.02, (r_k, r_ef)


def test_packed_neighbor_table_matches_unpacked(ds, graph):
    """device_graph packs p=128/W layer-0 lists per (8,128)-tile row (the
    16.78M serving OOM was XLA's pad-to-128 relayout copy of the (N, 64)
    table — hnsw._pack_neighbors). The packed gather + parity select must
    be result-identical to the legacy unpacked gather."""
    import jax.numpy as jnp

    from shine_tpu.models.hnsw import batched_search, device_graph

    dev, top = device_graph(graph)
    W = graph.neighbors0.shape[1]
    assert W < 128 and dev.neighbors0.shape[1] == 128  # packed
    unpacked = dev._replace(neighbors0=jnp.asarray(graph.neighbors0))
    sp = SearchParams(k=10, ef=48).resolved()
    q = jnp.asarray(ds.queries[:64].astype(np.float32))
    a_i, a_d = batched_search(
        dev, q, top_level=top, search_params=sp,
        metric=graph.params.metric_id, nbr_width=W,
    )
    b_i, b_d = batched_search(
        unpacked, q, top_level=top, search_params=sp,
        metric=graph.params.metric_id, nbr_width=0,
    )
    np.testing.assert_array_equal(np.asarray(a_i), np.asarray(b_i))
    np.testing.assert_array_equal(np.asarray(a_d), np.asarray(b_d))
