"""Scan index family: exact brute force (FlatIndex) and clustered
IVF (IVFIndex) — recall vs the numpy oracle."""

import numpy as np
import pytest

from shine_tpu.io import brute_force_knn, recall_at_k, synthetic_dataset
from shine_tpu.models.flat import FlatIndex
from shine_tpu.models.ivf import IVFIndex


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(n=6000, dim=32, num_queries=200, seed=13)


def test_flat_exact_f32(ds):
    idx = FlatIndex(ds.base)
    ids, dists = idx.search(ds.queries, 10, chunk=2048, use_bf16=False)
    assert recall_at_k(ids, ds.ground_truth, 10) == pytest.approx(1.0)
    assert np.all(np.diff(dists, axis=1) >= -1e-5)


def test_flat_bf16_reranked(ds):
    idx = FlatIndex(ds.base)
    ids, _ = idx.search(ds.queries, 10, chunk=2048, use_bf16=True)
    # bf16 scan + f32 re-rank: near-exact
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.99


def test_flat_ip_metric():
    ds = synthetic_dataset(n=3000, dim=24, num_queries=64, seed=4, metric="ip")
    idx = FlatIndex(ds.base, metric="ip")
    ids, _ = idx.search(ds.queries, 10, chunk=1024, use_bf16=False)
    assert recall_at_k(ids, ds.ground_truth, 10) == pytest.approx(1.0)


def test_flat_tail_chunk(ds):
    """N not divisible by chunk: tail must be masked, not read OOB."""
    idx = FlatIndex(ds.base[:5000])
    gt, _ = brute_force_knn(ds.base[:5000], ds.queries, 10)
    ids, _ = idx.search(ds.queries, 10, chunk=4096, use_bf16=False)
    assert recall_at_k(ids, gt, 10) == pytest.approx(1.0)


def test_ivf_recall(ds):
    idx = IVFIndex(ds.base, num_clusters=64, seed=7)
    ids, dists = idx.search(ds.queries, 10, probes=8)
    r = recall_at_k(ids, ds.ground_truth, 10)
    assert r > 0.9, r
    assert np.all(np.diff(dists, axis=1) >= -1e-2)


def test_ivf_more_probes_higher_recall(ds):
    idx = IVFIndex(ds.base, num_clusters=64, seed=7)
    r = []
    for p in (2, 8, 32):
        ids, _ = idx.search(ds.queries, 10, probes=p)
        r.append(recall_at_k(ids, ds.ground_truth, 10))
    assert r[0] <= r[1] <= r[2]
    assert r[2] > 0.99


def test_ivf_layout_partition(ds):
    """Every base row appears exactly once across cluster blocks."""
    idx = IVFIndex(ds.base, num_clusters=32, seed=7)
    ids = np.asarray(idx.data.block_ids)
    real = ids[ids >= 0]
    assert sorted(real.tolist()) == list(range(len(ds.base)))
    # capacity respected
    per = (ids >= 0).sum(axis=1)
    assert per.max() <= idx.data.cap


def test_sharded_ivf_recall(ds):
    from shine_tpu.parallel import shard_mesh
    from shine_tpu.parallel.ivf_sharded import ShardedIVFIndex

    mesh = shard_mesh(4)
    idx = ShardedIVFIndex(ds.base, mesh, num_clusters=64, seed=7)
    ids, dists = idx.search(ds.queries, 10, probes=8)
    r = recall_at_k(ids, ds.ground_truth, 10)
    assert r > 0.9, r
    assert np.all(np.diff(dists, axis=1) >= -1e-3)


def test_sharded_ivf_full_probes_exact(ds):
    """Probing every cluster must recover the exact top-k (partition is
    lossless; the f32 re-rank is exact)."""
    from shine_tpu.parallel import shard_mesh
    from shine_tpu.parallel.ivf_sharded import ShardedIVFIndex

    mesh = shard_mesh(4)
    idx = ShardedIVFIndex(ds.base, mesh, num_clusters=32, seed=7)
    ids, _ = idx.search(ds.queries, 10, probes=32, rerank=8)
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.99


def test_ivf_routed_recall(ds):
    """Tile-shared probing must track the per-query probe path: queries
    are affinity-sorted so each tile's union covers its members' probes."""
    idx = IVFIndex(ds.base, num_clusters=64, seed=7)
    ids, dists, stats = idx.search_routed(
        ds.queries, 10, probes=8, shared=48, tile=32, with_stats=True
    )
    r = recall_at_k(ids, ds.ground_truth, 10)
    assert r > 0.9, (r, stats)
    assert stats["probe_coverage"] > 0.85
    assert np.all(np.diff(dists, axis=1) >= -1e-2)


def test_ivf_routed_full_union_matches_per_query(ds):
    """With probes = shared = num_clusters every query wishes for every
    cluster, so each tile's union is the whole base and the routed path
    must be near-exact (the union holds only clusters someone probed —
    shared >= C alone does not imply a full scan)."""
    idx = IVFIndex(ds.base, num_clusters=32, seed=7)
    ids, _ = idx.search_routed(
        ds.queries, 10, probes=32, shared=32, tile=64
    )
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.99


def test_ivf_routed_order_restored(ds):
    """Results come back in the caller's query order despite the internal
    affinity sort (shuffled queries give the same rows, permuted)."""
    idx = IVFIndex(ds.base, num_clusters=64, seed=7)
    perm = np.random.default_rng(3).permutation(len(ds.queries))
    i1, _ = idx.search_routed(ds.queries, 10, probes=8, shared=48, tile=32)
    i2, _ = idx.search_routed(ds.queries[perm], 10, probes=8, shared=48, tile=32)
    # identical probe unions aren't guaranteed under a different sort order,
    # so compare via recall rather than exact ids
    r1 = recall_at_k(i1[perm], ds.ground_truth[perm], 10)
    r2 = recall_at_k(i2, ds.ground_truth[perm], 10)
    assert abs(r1 - r2) < 0.05


def test_ivf_routed_fallback_spills_to_per_query(ds):
    """fallback=1.1 spills every query (granted fraction <= 1), so routed
    results must exactly equal the per-query probe path."""
    idx = IVFIndex(ds.base, num_clusters=64, seed=7)
    ri, rd, st = idx.search_routed(
        ds.queries, 10, probes=8, shared=16, tile=64, fallback=1.1,
        with_stats=True,
    )
    assert st["fallback_queries"] == len(ds.queries)
    pi, pd = idx.search(ds.queries, 10, probes=8)
    np.testing.assert_array_equal(ri, pi)
    np.testing.assert_allclose(rd, pd, rtol=1e-5)


def test_sharded_ivf_routed_recall(ds):
    from shine_tpu.parallel import shard_mesh
    from shine_tpu.parallel.ivf_sharded import ShardedIVFIndex

    mesh = shard_mesh(4)
    idx = ShardedIVFIndex(ds.base, mesh, num_clusters=64, seed=7)
    ids, dists = idx.search_routed(
        ds.queries, 10, probes=8, shared=48, tile=32
    )
    r = recall_at_k(ids, ds.ground_truth, 10)
    assert r > 0.9, r
    assert np.all(np.diff(dists, axis=1) >= -1e-3)


def test_sharded_ivf_routed_full_probes_exact(ds):
    """probes = shared = C: every tile's union is every cluster; the
    sharded routed path must be near-exact like the per-query one."""
    from shine_tpu.parallel import shard_mesh
    from shine_tpu.parallel.ivf_sharded import ShardedIVFIndex

    mesh = shard_mesh(4)
    idx = ShardedIVFIndex(ds.base, mesh, num_clusters=32, seed=7)
    ids, _ = idx.search_routed(
        ds.queries, 10, probes=32, shared=32, tile=64, rerank=8
    )
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.99


def test_ivf_probe_chunk_identical(ds):
    """The lax.scan probe-streaming path (used when the full (B,p,cap,d)
    gather would OOM the chip) must return exactly the one-shot result."""
    import jax.numpy as jnp

    from shine_tpu.models.ivf import ivf_search

    idx = IVFIndex(ds.base, num_clusters=64, seed=7)
    q = jnp.asarray(ds.queries[:64].astype(np.float32))
    i1, d1 = ivf_search(idx.data, q, k=10, p=8, metric=idx.metric)
    i2, d2 = ivf_search(idx.data, q, k=10, p=8, metric=idx.metric, probe_chunk=2)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-6)


def test_ivf_routed_chunked_scan_matches(ds):
    """A tiny step_budget forces the tile-group streaming path (the 10M
    big-cap regime, models/ivf.py): results must equal the single-step
    scan exactly."""
    from shine_tpu.models.ivf import ivf_routed_search

    import jax.numpy as jnp

    idx = IVFIndex(ds.base, num_clusters=64, seed=7)
    q = jnp.asarray(ds.queries[:128].astype(np.float32))
    a_i, a_d, a_cov, a_g = ivf_routed_search(
        idx.data, q, k=10, p=8, shared=48, tile=32, metric=0
    )
    b_i, b_d, b_cov, b_g = ivf_routed_search(
        idx.data, q, k=10, p=8, shared=48, tile=32, metric=0,
        step_budget=1,  # gc=1 -> one tile-group per scan step
    )
    np.testing.assert_array_equal(np.asarray(a_i), np.asarray(b_i))
    np.testing.assert_allclose(np.asarray(a_d), np.asarray(b_d),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(a_cov), float(b_cov))


def test_measured_defaults_auto_clusters():
    """The routed serving mode auto-picks COARSE clusters (C clamped to
    ~2k at any N — at 1M x 64 a fine C=7813 collapses routed coverage
    to 0.45/recall 0.55); fine stays cap~target_cap."""
    from shine_tpu.models.ivf import _auto_clusters

    assert _auto_clusters(200_000, 128, "fine") == -(-200_000 // 128)
    assert _auto_clusters(200_000, 128, "routed") == 1563
    assert _auto_clusters(1_000_000, 128, "routed") == 2048  # clamp
    assert _auto_clusters(10_000_000, 128, "routed") == 2048
    assert _auto_clusters(500, 128, "routed") == 8
    with pytest.raises(ValueError):
        _auto_clusters(1000, 128, "coarse")


def test_measured_defaults_keep2_auto():
    """keep2 auto-enables once rows-per-class >= ~500 (the measured
    one-decoy regime)."""
    from shine_tpu.models.flat import keep2_auto

    assert not keep2_auto(200_704, 1024)  # 200k x 128 bench: ~195 r/cls
    assert keep2_auto(1_000_448, 1024)  # 1M: ~976 r/cls
    assert not keep2_auto(1_000_448, 2048)  # rule is cls-aware: 488 r/cls
    assert not keep2_auto(499 * 1024, 1024)
    assert keep2_auto(500 * 1024, 1024)


def test_resolve_knobs_at_headline_shapes():
    """Lock the full auto-knob tuple (kb, cls, keep2) at two operating
    shapes: 200k x 128 (keep1/cls2048 at kb=32) and 1M x 128
    (keep2/cls1024 at kb=64 — against exact ground truth kb32 scores
    0.9914 and kb64 recovers 1.0000). An auto-rule change that silently
    moves either config should fail here first, not on the chip."""
    from shine_tpu.models.flat import FastFlatIndex, kb_auto

    def resolved(n_pad):
        idx = FastFlatIndex.__new__(FastFlatIndex)
        idx.ext = np.zeros((n_pad, 8), np.int8)  # only .shape[0] is read
        idx.dim = 128
        return idx._resolve_knobs(0, 0, None)

    assert resolved(200_704) == (32, 2048, False)
    assert resolved(1_048_576) == (64, 1024, True)
    assert kb_auto(200_704, 128) == 32
    assert kb_auto(999_999, 128) == 32
    assert kb_auto(1_000_000, 128) == 64
    assert kb_auto(1_048_576, 960) == 128


def test_flat_search_f32_leg_requests_highest_precision():
    """Regression for a device ground-truth corruption: DEFAULT matmul
    precision may run f32 operands at bf16 or TF32 grade, so the exact
    scan (use_bf16=False — the path every device ground truth rides)
    MUST request HIGHEST explicitly. CPU execution can't observe the
    truncation, so assert it structurally: every f32 dot_general in the
    traced program carries HIGHEST."""
    import jax
    from shine_tpu.models.flat import flat_search

    idx = FlatIndex(np.zeros((4096, 16), np.float32))

    def collect(jaxpr, out):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                in_dtypes = tuple(v.aval.dtype for v in eqn.invars)
                out.append((in_dtypes, eqn.params.get("precision")))
            for v in eqn.params.values():
                sub = getattr(v, "jaxpr", None)
                if sub is not None:
                    collect(sub, out)
                if isinstance(v, (list, tuple)):
                    for w in v:
                        sub = getattr(w, "jaxpr", None)
                        if sub is not None:
                            collect(sub, out)
        return out

    q = np.zeros((8, 16), np.float32)
    jaxpr = jax.make_jaxpr(
        lambda qq: flat_search(idx.data, qq, k=5, use_bf16=False)
    )(q).jaxpr
    dots = collect(jaxpr, [])
    f32_dots = [
        p for dts, p in dots
        if all(dt == np.float32 for dt in dts)
    ]
    assert f32_dots, "expected at least one f32 dot_general in the scan"
    H = jax.lax.Precision.HIGHEST
    assert all(p == (H, H) for p in f32_dots), f32_dots


def test_ivf_search_exact_full_probes_large_c():
    """p == num_clusters must scan everything EXACTLY even above the 4096-
    cluster threshold where stage 1 used to switch to approx_max_k
    silently (ADVICE r2, medium): default probe selection is exact."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(4608, 8)).astype(np.float32)
    q = rng.normal(size=(32, 8)).astype(np.float32)
    gt, _ = brute_force_knn(base, q, 10)
    idx = IVFIndex(base, num_clusters=4096, seed=7, train_size=4608)
    ids, _ = idx.search(q, 10, probes=4096, rerank=8)
    assert recall_at_k(ids, gt, 10) == pytest.approx(1.0)


def test_ivf_routed_default_fallback_floor(ds):
    """search_routed's default per-query fallback (0.5) spills starved
    queries to the exact probe path — a deliberately tiny shared union
    must still deliver probe-path recall (the reference's spill path,
    query_router.hh:353-370)."""
    idx = IVFIndex(ds.base, num_clusters=64, seed=7)
    ids, _, stats = idx.search_routed(
        ds.queries, 10, probes=8, shared=4, tile=64, with_stats=True
    )
    assert stats["fallback_queries"] > 0
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.85


def test_ivf_routed_layout(ds):
    """layout='routed' end-to-end: coarse auto-C, healthy coverage, no
    fallback storm."""
    idx = IVFIndex(ds.base, seed=7, layout="routed", train_size=6000)
    assert idx.data.num_clusters <= 2048
    ids, _, stats = idx.search_routed(
        ds.queries, 10, probes=8, shared=32, tile=32, with_stats=True
    )
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.9


def test_sharded_ivf_compact_lanes_match_dense(ds):
    """Owned-probe lane compaction (VERDICT r2 #5): identical results to
    the masked full-width scan, with the cluster-total scanned-lane
    counter dropping toward B*p (vs the dense path's S*B*p) — the
    reference's 'owners serve only requested rows' (rdma_reads.hh:
    101-134)."""
    from shine_tpu.parallel import shard_mesh
    from shine_tpu.parallel.ivf_sharded import ShardedIVFIndex

    mesh = shard_mesh(4)
    idx = ShardedIVFIndex(ds.base, mesh, num_clusters=32, seed=7)
    ci, cd = idx.search(ds.queries, 10, probes=8)  # compact default
    lanes_compact = idx.scanned_lanes
    assert idx.rpc_rounds > 0
    di, dd = idx.search(ds.queries, 10, probes=8, probe_lanes="dense")
    lanes_dense = idx.scanned_lanes - lanes_compact
    np.testing.assert_array_equal(ci, di)
    np.testing.assert_allclose(cd, dd, rtol=1e-5, atol=1e-5)
    # S=4, slack=2 -> PL=4 lanes/query vs p=8 dense: >=2x fewer scanned
    # lanes even if every round runs on every shard
    assert lanes_compact < lanes_dense / 1.5, (lanes_compact, lanes_dense)
