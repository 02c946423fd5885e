"""On-device batched construction (SURVEY.md §7.2 Phase 3): the batched
insert rounds must produce a valid graph with recall parity against the
native sequential builder."""

import numpy as np
import pytest

from shine_tpu.config import HNSWParams, SearchParams
from shine_tpu.graph import build_graph
from shine_tpu.io import recall_at_k, synthetic_dataset
from shine_tpu.models import HNSWIndex, device_build_graph
from shine_tpu.models.build import draw_levels


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(n=3000, dim=24, num_queries=100, seed=5)


@pytest.fixture(scope="module")
def dev_graph(ds):
    return device_build_graph(
        ds.base,
        HNSWParams(M=12, ef_construction=80),
        batch_size=256,
        first_batch=16,
    )


def test_device_build_valid(dev_graph):
    dev_graph.validate()


def test_device_build_recall(ds, dev_graph):
    idx = HNSWIndex(dev_graph)
    ids, _ = idx.search(ds.queries, SearchParams(k=10, ef=64), batch_size=64)
    r = recall_at_k(ids, ds.ground_truth, 10)
    assert r > 0.95, r


def test_device_build_parity_with_native(ds, dev_graph):
    """Within-round blindness must not cost recall vs the sequential
    native build (reference insert semantics)."""
    native = build_graph(ds.base, HNSWParams(M=12, ef_construction=80))
    sp = SearchParams(k=10, ef=64)
    r_native = recall_at_k(
        HNSWIndex(native).search(ds.queries, sp, batch_size=64)[0],
        ds.ground_truth,
        10,
    )
    r_dev = recall_at_k(
        HNSWIndex(dev_graph).search(ds.queries, sp, batch_size=64)[0],
        ds.ground_truth,
        10,
    )
    assert r_dev > r_native - 0.02, (r_dev, r_native)


def test_degrees_bounded(dev_graph):
    M = dev_graph.params.M
    deg0 = (dev_graph.neighbors0 >= 0).sum(axis=1)
    assert deg0.max() <= 2 * M
    up = (dev_graph.upper_neighbors >= 0).sum(axis=2)
    assert up.max() <= M


def test_level_draw_matches_geometric():
    params = HNSWParams(M=16, seed=9)
    lv = draw_levels(200_000, params)
    frac = (lv >= 1).mean()
    assert 0.8 / 16 < frac < 1.25 / 16


def test_sharded_insert_round_matches_single(ds):
    """Data-parallel plan + replicated deterministic apply must produce the
    same graph as the single-device round (sorted reverse-edge resolution
    is order-independent)."""
    import jax.numpy as jnp
    import numpy as np

    from shine_tpu.models.build import (
        init_build_state,
        insert_round,
        make_sharded_insert_round,
    )
    from shine_tpu.parallel import shard_mesh

    params = HNSWParams(M=8, ef_construction=40)
    base = ds.base[:800]
    S, B = 4, 64
    st_a = init_build_state(base, params)
    st_b = init_build_state(base, params)
    mesh = shard_mesh(S)
    run = make_sharded_insert_round(
        mesh, ef=40, frontier=4, max_add=16, metric=0, B_up_loc=B // S
    )
    count = 1
    while count < 400:
        b = min(B, 400 - count)
        ids = np.full(B, -1, dtype=np.int32)
        ids[:b] = np.arange(count, count + b, dtype=np.int32)
        st_a = insert_round(
            st_a, jnp.asarray(ids), ef=40, frontier=4, max_add=16,
            metric=0, B_up=B,
        )
        st_b = run(st_b, jnp.asarray(ids))
        count += b
    np.testing.assert_array_equal(
        np.asarray(st_a.neighbors0), np.asarray(st_b.neighbors0)
    )
    np.testing.assert_array_equal(
        np.asarray(st_a.upper_neighbors), np.asarray(st_b.upper_neighbors)
    )
    assert int(st_a.entry_point) == int(st_b.entry_point)
    assert int(st_a.count) == int(st_b.count) == 400


def test_estimate_index_bytes():
    from shine_tpu.graph.soa import estimate_index_bytes

    params = HNSWParams(M=16)
    b = estimate_index_bytes(100_000, 128, params)
    # vector+l0 dominate: ~ (128*4 + 8 + 128)
    assert 5e7 < b < 1e8


def test_fast_build_graph_sharded_matches_single(ds, monkeypatch):
    """A mesh-sharded fastbuild must be BIT-identical to the single-chip
    build: the kNN stage shards rows over the devices but per-row f32
    distances are layout-independent and every tie-break is (dist, id)
    (VERDICT r3 #2 — the 100M-class graph is per-shard fastbuilds; this
    is the orchestration-identity leg, the 16.78M per-shard unit runs on
    the chip, results/scale_10m_hnsw.jsonl)."""
    import shine_tpu.models.fastbuild as fb
    from shine_tpu.parallel import shard_mesh

    monkeypatch.setattr(fb, "SHARD_KNN_MIN", 256)
    p = HNSWParams(M=8, ef_construction=60)
    g1 = fb.fast_build_graph(ds.base, p, exact_knn=True)
    mesh = shard_mesh(4)
    g2 = fb.fast_build_graph(ds.base, p, exact_knn=True, mesh=mesh)
    np.testing.assert_array_equal(g1.neighbors0, g2.neighbors0)
    np.testing.assert_array_equal(g1.levels, g2.levels)
    np.testing.assert_array_equal(g1.upper_neighbors, g2.upper_neighbors)
    assert g1.entry_point == g2.entry_point

    # round-trip: the mesh-built graph serves over the SAME mesh
    from shine_tpu.parallel import ShardedIndex

    sids, _ = ShardedIndex(g2, mesh).search(
        ds.queries[:64], SearchParams(k=10, ef=48), batch_size=64
    )
    oids, _ = HNSWIndex(g1).search(
        ds.queries[:64], SearchParams(k=10, ef=48), batch_size=64
    )
    np.testing.assert_array_equal(sids, oids)


def test_fast_build_pool_widening(ds):
    """pool= (the ef_construction analog): a wider exact candidate pool
    must yield a valid graph whose recall is not worse than the default
    2M pool (it feeds select_heuristic a superset)."""
    from shine_tpu.models.fastbuild import fast_build_graph

    p = HNSWParams(M=8, ef_construction=80)
    g0 = fast_build_graph(ds.base, p, exact_knn=True)
    g1 = fast_build_graph(ds.base, p, exact_knn=True, pool=96)
    g1.validate()
    sp = SearchParams(k=10, ef=48)
    r0 = recall_at_k(
        HNSWIndex(g0).search(ds.queries, sp, batch_size=64)[0],
        ds.ground_truth, 10,
    )
    r1 = recall_at_k(
        HNSWIndex(g1).search(ds.queries, sp, batch_size=64)[0],
        ds.ground_truth, 10,
    )
    assert r1 >= r0 - 0.01, (r0, r1)


def test_fast_build_graph(ds):
    """Scan-based construction (models/fastbuild.py): valid graph, recall
    parity with the incremental native builder."""
    from shine_tpu.models.fastbuild import fast_build_graph

    g = fast_build_graph(
        ds.base, HNSWParams(M=12, ef_construction=80), exact_knn=True
    )
    g.validate()
    idx = HNSWIndex(g)
    ids, _ = idx.search(ds.queries, SearchParams(k=10, ef=64), batch_size=64)
    r = recall_at_k(ids, ds.ground_truth, 10)
    native = build_graph(ds.base, HNSWParams(M=12, ef_construction=80))
    rn = recall_at_k(
        HNSWIndex(native).search(ds.queries, SearchParams(k=10, ef=64), batch_size=64)[0],
        ds.ground_truth, 10,
    )
    assert r > rn - 0.02, (r, rn)


def test_dynamic_online_insert(ds):
    """Online insertion (the reference's runtime insert capability): add
    in chunks, search between additions, recall holds."""
    from shine_tpu.models.dynamic import DynamicHNSWIndex
    from shine_tpu.io import brute_force_knn

    base = ds.base[:2000]
    dyn = DynamicHNSWIndex(
        base.shape[1], capacity=2500, params=HNSWParams(M=12, ef_construction=80),
        batch_size=128,
    )
    dyn.add(base[:1200])
    idx = dyn.searcher()
    idx.graph.validate()
    gt1, _ = brute_force_knn(base[:1200], ds.queries, 10)
    ids, _ = idx.search(ds.queries, SearchParams(k=10, ef=64), batch_size=64)
    assert recall_at_k(ids, gt1, 10) > 0.93

    dyn.add(base[1200:])
    idx = dyn.searcher()
    idx.graph.validate()
    gt2, _ = brute_force_knn(base, ds.queries, 10)
    ids, _ = idx.search(ds.queries, SearchParams(k=10, ef=64), batch_size=64)
    assert recall_at_k(ids, gt2, 10) > 0.93
    import pytest as _p

    with _p.raises(ValueError):
        dyn.add(np.zeros((1000, base.shape[1]), np.float32))


def test_dynamic_sharded_matches_single(ds):
    """Online insertion over a mesh (the reference's concurrent
    distributed inserts, hnsw.hh:40-251): the data-parallel rounds must
    build the bit-identical graph, and the sharded searcher must serve
    from it."""
    from shine_tpu.models.dynamic import DynamicHNSWIndex
    from shine_tpu.parallel import shard_mesh

    base = ds.base[:1200]
    params = HNSWParams(M=12, ef_construction=80)
    kw = dict(capacity=1200, params=params, batch_size=128)
    single = DynamicHNSWIndex(base.shape[1], **kw)
    mesh = shard_mesh(4)
    sharded = DynamicHNSWIndex(base.shape[1], mesh=mesh, **kw)
    for lo, hi in ((0, 500), (500, 1000), (1000, 1200)):
        single.add(base[lo:hi])
        sharded.add(base[lo:hi])
    ga, gb = single.snapshot(), sharded.snapshot()
    np.testing.assert_array_equal(ga.neighbors0, gb.neighbors0)
    np.testing.assert_array_equal(ga.upper_neighbors, gb.upper_neighbors)
    assert ga.entry_point == gb.entry_point

    idx = sharded.searcher()
    from shine_tpu.io import brute_force_knn

    gt, _ = brute_force_knn(base, ds.queries, 10)
    ids, _ = idx.search(ds.queries, SearchParams(k=10, ef=64), batch_size=64)
    assert recall_at_k(ids, gt, 10) > 0.93


def test_fast_build_graph_device_base():
    """The device-resident build path (base_dev=): layer-0 self-kNN runs
    as the fused device sweep, selects reuse the resident base — recall
    must match the host-path build within noise (the 10M-scale path)."""
    import jax.numpy as jnp

    from shine_tpu.io import synthetic_dataset
    from shine_tpu.models.fastbuild import fast_build_graph

    ds = synthetic_dataset(n=8192, dim=16, num_queries=100, seed=21)
    p = HNSWParams(M=8, ef_construction=50)
    g = fast_build_graph(
        ds.base, p, base_dev=jnp.asarray(ds.base)
    )
    g.validate()
    idx = HNSWIndex(g)
    ids, _ = idx.search(ds.queries, SearchParams(k=10, ef=64), batch_size=100)
    r = recall_at_k(ids, ds.ground_truth, 10)
    assert r > 0.9, r


def test_fast_build_stage_checkpoint(ds, tmp_path, monkeypatch):
    """Mid-build resume (stage_path=): a rebuild pointed at the stage-0
    checkpoint must (a) never re-run the layer-0 kNN, and (b) produce a
    bit-identical graph. A mismatched key (different M) must ignore the
    file rather than load a wrong layer 0."""
    import shine_tpu.models.fastbuild as fb

    p = HNSWParams(M=12, ef_construction=80)
    stage = str(tmp_path / "stage0.npz")
    g1 = fb.fast_build_graph(ds.base, p, exact_knn=True, stage_path=stage)
    import os

    assert os.path.exists(stage)

    n = len(ds.base)
    orig = fb._knn_candidates

    def guard(vectors, ids, k, metric, exact_knn, mesh=None):
        assert len(ids) < n, "layer-0 kNN re-ran despite the checkpoint"
        return orig(vectors, ids, k, metric, exact_knn, mesh)

    monkeypatch.setattr(fb, "_knn_candidates", guard)
    g2 = fb.fast_build_graph(ds.base, p, exact_knn=True, stage_path=stage)
    np.testing.assert_array_equal(g1.neighbors0, g2.neighbors0)
    np.testing.assert_array_equal(g1.levels, g2.levels)
    np.testing.assert_array_equal(g1.upper_neighbors, g2.upper_neighbors)
    assert g1.entry_point == g2.entry_point
    assert g1.top_level == g2.top_level

    # wrong key (M differs) -> checkpoint ignored, full build runs
    monkeypatch.setattr(fb, "_knn_candidates", orig)
    p2 = HNSWParams(M=8, ef_construction=80)
    g3 = fb.fast_build_graph(ds.base, p2, exact_knn=True, stage_path=stage)
    assert g3.neighbors0.shape[1] == 16  # M0 = 2*M for the new params


def test_reverse_merge_native_identity():
    """The C++ reverse-merge stage (native/hnsw_builder.cc:
    shine_reverse_merge) must be BIT-identical to the numpy twin
    (fastbuild._reverse_merge_np) — adversarial input: heavy distance
    ties (quantized), mutual edges (duplicate ids in the union),
    non-contiguous global ids, -1 pads, and a cap that forces rank
    cuts."""
    import pytest

    from shine_tpu.models.fastbuild import _reverse_merge_np

    try:
        from shine_tpu.native import reverse_merge
    except Exception:
        pytest.skip("native toolchain unavailable")

    rng = np.random.default_rng(7)
    for n, M, cap_c, idspace in ((500, 8, 12, 1000), (2000, 6, 7, 2000)):
        ids = np.sort(
            rng.choice(idspace, size=n, replace=False)
        ).astype(np.int32)
        fwd_sel = np.empty((n, M), np.int32)
        fwd_d = np.empty((n, M), np.float32)
        for i in range(n):
            nb = rng.choice(n, size=M, replace=False)
            nb = nb[nb != i]
            d = np.round(rng.random(len(nb)) * 8) / 4  # heavy ties
            order = np.lexsort((ids[nb], d))
            k = len(nb) - int(rng.integers(0, 3))  # some -1 pads
            fwd_sel[i, :k] = ids[nb[order]][:k]
            fwd_d[i, :k] = d[order][:k]
            fwd_sel[i, k:] = -1
            fwd_d[i, k:] = np.inf
        want_c, want_d = _reverse_merge_np(fwd_sel, fwd_d, ids, cap_c)
        got_c, got_d = reverse_merge(fwd_sel, fwd_d, ids, cap_c)
        np.testing.assert_array_equal(got_c, want_c)
        np.testing.assert_array_equal(got_d, want_d)
        # per-row independence: any thread count is bit-identical
        got_c3, got_d3 = reverse_merge(fwd_sel, fwd_d, ids, cap_c,
                                       threads=3)
        np.testing.assert_array_equal(got_c3, want_c)
        np.testing.assert_array_equal(got_d3, want_d)


def test_drop_self_sorted_matches_lexsort():
    """_drop_self_sorted must be value-identical to the demote+lexsort
    formula it replaced (sorted rows, at most one self hit, -1 pads)."""
    from shine_tpu.models.fastbuild import _drop_self_sorted

    rng = np.random.default_rng(3)
    n, w, k = 257, 9, 8
    dd = np.sort(rng.random((n, w)).astype(np.float32), axis=1)
    # candidate ids never collide with the row index unless planted
    # (real rows are unique: distinct class winners / owned shards)
    ii = (n + rng.integers(0, n, (n, w))).astype(np.int32)
    # plant ONE self hit in ~half the rows, at random positions
    rows = rng.choice(n, n // 2, replace=False)
    ii[rows, rng.integers(0, w, n // 2)] = rows
    # some -1 pads at the tail (pads carry inf, after any self hit)
    ii[rows[:20], -1] = -1
    dd[rows[:20], -1] = np.inf
    want_i, want_d = ii.copy(), dd.copy()
    local = np.arange(n)[:, None]
    hit = want_i == local
    want_d = np.where(hit, np.inf, want_d)
    want_i = np.where(hit, -1, want_i)
    order = np.lexsort(
        (np.where(want_i < 0, 2**31 - 1, want_i), want_d), axis=1
    )
    want_i = np.take_along_axis(want_i, order, axis=1)[:, :k]
    want_d = np.take_along_axis(want_d, order, axis=1)[:, :k]
    got_i, got_d = _drop_self_sorted(ii, dd, k)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)


def test_sweep_select_level0_identity():
    """The fused device sweep+select (production layer-0 path) must be
    ARRAY-EQUAL to its reference composition — host-table sweep
    (_knn_device_sweep) -> pad -> _device_select — since it is exactly
    that pipeline with the (n, k+1) table kept on device."""
    import jax.numpy as jnp

    import shine_tpu.models.fastbuild as fb
    from shine_tpu.io import synthetic_dataset

    ds = synthetic_dataset(n=8192, dim=16, num_queries=1, seed=31)
    base_dev = jnp.asarray(ds.base)
    sqn = jnp.asarray((ds.base * ds.base).sum(-1).astype(np.float32))
    k, m_out, metric = 16, 8, 0
    cand, cd = fb._knn_device_sweep(base_dev, k, metric)
    ids = np.arange(len(ds.base), dtype=np.int32)
    sel_ref, _, seld_ref = fb._device_select(
        base_dev, sqn, ids, cand, cd, m_out, metric, with_dists=True
    )
    sel, sel_d = fb._sweep_select_level0(
        base_dev, base_dev, sqn, k, m_out, metric
    )
    np.testing.assert_array_equal(sel, sel_ref)
    np.testing.assert_array_equal(sel_d, seld_ref)


def test_sweep_int8_layout_recall(monkeypatch):
    """The int8 split sweep (the 16.78M HBM regime) re-ranks exact f32,
    so its kNN must stay distance-exact vs the brute-force oracle (id
    flips allowed only between equal distances)."""
    import jax.numpy as jnp

    import shine_tpu.models.fastbuild as fb
    from shine_tpu.io import synthetic_dataset
    from shine_tpu.io.recall import brute_force_knn

    monkeypatch.setenv("SHINE_SWEEP_SPLIT", "1")
    monkeypatch.setenv("SHINE_SWEEP_INT8", "1")
    ds = synthetic_dataset(n=4096, dim=16, num_queries=1, seed=33)
    base_dev = jnp.asarray(ds.base)
    cand, cd = fb._knn_device_sweep(base_dev, 8, 0)
    gt_i, gt_d = brute_force_knn(ds.base, ds.base, 9)
    # drop the self column from the oracle. Tolerance covers kernel-vs-
    # numpy f32 summation-order noise (~4e-5 relative measured); a
    # genuinely MISSED neighbor (int8 scan margin too thin) shows up as
    # a whole-gap distance jump, orders of magnitude above this.
    np.testing.assert_allclose(cd, gt_d[:, 1:], rtol=1e-3, atol=1e-3)


def test_sweep_hbm_precheck(monkeypatch):
    """A build whose planned HBM exceeds the budget must fail instantly
    host-side with the itemized plan, not RESOURCE_EXHAUSTED an hour in
    (chip_plan_r4h stage J)."""
    import shine_tpu.models.fastbuild as fb

    plan = fb._sweep_plan(
        16777216, 128, 64, 128, 4096, 1024, "int8", False,
    )
    assert plan["total"] < 15.2e9  # the fixed 16.78M M=32 config fits
    plan_bf16 = fb._sweep_plan(
        16777216, 128, 64, 81, 4096, 1024, "bf16", False,
    )
    monkeypatch.setenv("SHINE_HBM_BYTES", str(int(12e9)))
    with pytest.raises(RuntimeError, match="base_f32"):
        fb._check_sweep_plan(plan_bf16, "test")


def test_device_select_streaming_flush_identical(monkeypatch):
    """_device_select streams results to host in bounded groups (the old
    accumulate-all + device concatenate held 2x the full (B, M_out)
    output on device and OOM'd the 16.78M select2 — chip_plan_r5c stage
    B). Group size must not change values: force many tiny flushes and
    compare against one big group."""
    import shine_tpu.models.fastbuild as fb

    rng = np.random.default_rng(3)
    n, d, C, M_out = 3000, 16, 24, 8
    v = rng.standard_normal((n, d)).astype(np.float32)
    sq = (v * v).sum(-1).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    cand = rng.integers(0, n, (n, C)).astype(np.int32)
    cd = rng.random((n, C)).astype(np.float32)
    o = np.argsort(cd, axis=1)
    cd = np.take_along_axis(cd, o, 1)
    cand = np.take_along_axis(cand, o, 1)

    monkeypatch.setenv("SHINE_SELECT_FLUSH_MB", "512")
    a = fb._device_select(v, sq, ids, cand, cd, M_out, 0, batch=512,
                          with_dists=True)
    monkeypatch.setenv("SHINE_SELECT_FLUSH_MB", "0.01")
    b = fb._device_select(v, sq, ids, cand, cd, M_out, 0, batch=512,
                          with_dists=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
