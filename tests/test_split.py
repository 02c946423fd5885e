"""Split-layout scan (ops/classmax.classmax_split, models/flat.SplitFlatIndex)
and the shared re-rank / trim helpers."""

import jax.numpy as jnp
import numpy as np
import pytest

from shine_tpu.config import METRIC_L2


def _ref_scores(v, q, metric=METRIC_L2):
    """Exact f32 scores on the same rounding the kernel applies (bf16
    components, f32 norm)."""
    vb = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    qb = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    dots = qb @ vb.T
    if metric == METRIC_L2:
        return 2.0 * dots - (vb * vb).sum(1)[None, :]
    return dots


def test_classmax_scan_split_matches_numpy(rng):
    from shine_tpu.ops.classmax import classmax_split
    from shine_tpu.ops.packing import pack_split_query, pack_split_tables

    n, d, B = 4096, 64, 128
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    comp, aux = pack_split_tables(v, METRIC_L2, n)
    cls, tn = 512, 1024
    m1, a1 = classmax_split(
        jnp.asarray(comp).astype(jnp.bfloat16), jnp.asarray(aux),
        pack_split_query(jnp.asarray(q), comp.shape[1]), tn=tn, cls=cls,
    )
    scores = _ref_scores(v, q)
    # class of row r = r % cls under the strided layout
    want = np.full((B, cls), -3e38, np.float32)
    wrow = np.zeros((B, cls), np.int32)
    for r in range(n):
        c = r % cls
        better = scores[:, r] > want[:, c]
        wrow[:, c] = np.where(better, r, wrow[:, c])
        want[:, c] = np.maximum(want[:, c], scores[:, r])
    np.testing.assert_array_equal(np.asarray(a1), wrow)
    np.testing.assert_allclose(np.asarray(m1), want, rtol=1e-5, atol=1e-3)


def test_classmax_scan_split_keep2(rng):
    from shine_tpu.ops.classmax import classmax_split
    from shine_tpu.ops.packing import pack_split_query, pack_split_tables

    n, d, B, cls = 2048, 32, 128, 256
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    comp, aux = pack_split_tables(v, METRIC_L2, n)
    m1, a1, m2, a2 = classmax_split(
        jnp.asarray(comp).astype(jnp.bfloat16), jnp.asarray(aux),
        pack_split_query(jnp.asarray(q), comp.shape[1]), tn=512, cls=cls,
        keep2=True,
    )
    scores = _ref_scores(v, q)
    m1n, m2n = np.asarray(m1), np.asarray(m2)
    for b in range(0, B, 17):
        for c in range(0, cls, 37):
            col = scores[b, c::cls]
            srt = np.sort(col)[::-1]
            assert abs(srt[0] - m1n[b, c]) < 2e-3
            assert abs(srt[1] - m2n[b, c]) < 2e-3
    # runner-up never equals the winner row
    assert not (np.asarray(a1) == np.asarray(a2)).all()


def test_split_index_exact_rerank_recall(rng):
    """bf16 components + exact f32 re-rank: recall ~1 vs brute force."""
    from shine_tpu.io import recall_at_k, synthetic_dataset
    from shine_tpu.models.flat import FlatIndex, SplitFlatIndex

    ds = synthetic_dataset(n=6000, dim=48, num_queries=64, seed=3, gt_k=10)
    idx = SplitFlatIndex(ds.base)
    ids, dd = idx.search(ds.queries, 10, kb=16, cls=256, keep2=False)
    r = recall_at_k(ids, ds.ground_truth, 10)
    assert r >= 0.97, r
    # distances are the exact f32 distances of the returned ids
    flat = FlatIndex(ds.base)
    fi, fd = flat.search(ds.queries, 10)
    match = (ids == fi)
    np.testing.assert_allclose(dd[match], fd[match], rtol=1e-4, atol=1e-3)


def test_split_index_int8_recall(rng):
    """int8 components, exact f32 re-rank from the resident base: the
    scan's candidate lists absorb the ~s/127 quantization noise."""
    from shine_tpu.io import recall_at_k, synthetic_dataset
    from shine_tpu.models.flat import SplitFlatIndex

    ds = synthetic_dataset(n=6000, dim=48, num_queries=64, seed=5, gt_k=10)
    idx = SplitFlatIndex(ds.base, comp_dtype="int8")
    ids, _ = idx.search(ds.queries, 10, kb=24, cls=256, keep2=True)
    r = recall_at_k(ids, ds.ground_truth, 10)
    assert r >= 0.93, r


def test_split_capacity_rerank_paths(rng):
    """from_parts (no resident base): split-table re-rank, and the exact
    regen re-rank when a row_source is attached."""
    import jax

    from shine_tpu.io import recall_at_k
    from shine_tpu.io.device_synth import regen_rows
    from shine_tpu.models.flat import FlatIndex, SplitFlatIndex
    from shine_tpu.ops.packing import comp_width, pack_split_device

    key = jax.random.PRNGKey(11)
    centers = jax.random.normal(
        jax.random.PRNGKey(1), (8, 32), jnp.float32
    ) * 4.0
    n, d = 4096, 32
    base = np.asarray(
        regen_rows(key, centers, jnp.arange(n, dtype=jnp.int32))
    )
    q = base[rng.integers(0, n, 48)] + 0.3 * rng.normal(
        size=(48, d)
    ).astype(np.float32)
    gt, _ = FlatIndex(base).search(q, 10)
    comp, aux = pack_split_device(
        jnp.asarray(base), metric=METRIC_L2, dpc=comp_width(d)
    )
    idx = SplitFlatIndex.from_parts(comp, aux, n, dim=d)
    ids, _ = idx.search(q, 10, kb=16, cls=256, keep2=False)
    assert recall_at_k(ids, gt, 10) >= 0.95
    # exact regen re-rank
    idx2 = SplitFlatIndex.from_parts(
        comp, aux, n, dim=d, row_source=(key, centers)
    )
    ids2, dd2 = idx2.search(q, 10, kb=16, cls=256, keep2=False)
    assert recall_at_k(ids2, gt, 10) >= 0.97
    # regen re-rank distances are exact f32 distances
    fd, fi = FlatIndex(base).search(q, 10)[1], gt
    match = ids2 == fi
    np.testing.assert_allclose(dd2[match], fd[match], rtol=1e-4, atol=1e-3)


def test_pack_split_device_matches_host(rng):
    from shine_tpu.ops.packing import (
        comp_width,
        pack_split_device,
        pack_split_tables,
    )

    n, d = 4096, 40
    v = rng.normal(size=(n, d)).astype(np.float32)
    ch, ah = pack_split_tables(v, METRIC_L2, n)
    cd, ad = pack_split_device(
        jnp.asarray(v), metric=METRIC_L2, dpc=comp_width(d)
    )
    np.testing.assert_allclose(
        np.asarray(cd.astype(jnp.float32)), ch, rtol=0, atol=0
    )
    np.testing.assert_allclose(np.asarray(ad), ah, rtol=1e-6, atol=1e-5)
    # int8 variants agree too
    ch8, ah8 = pack_split_tables(v, METRIC_L2, n, comp_dtype=np.int8)
    cd8, ad8 = pack_split_device(
        jnp.asarray(v), metric=METRIC_L2, dpc=comp_width(d), int8=True
    )
    assert cd8.dtype == jnp.int8
    np.testing.assert_array_equal(np.asarray(cd8), ch8)
    np.testing.assert_allclose(np.asarray(ad8), ah8, rtol=1e-5, atol=1e-5)


def test_approx_select_paths(rng):
    """approx_sel=True (lax.approx_max_k class selection) keeps recall
    within noise of the exact top_k select on both scan families."""
    from shine_tpu.io import recall_at_k, synthetic_dataset
    from shine_tpu.models.flat import FastFlatIndex, SplitFlatIndex

    ds = synthetic_dataset(n=6000, dim=48, num_queries=64, seed=4, gt_k=10)
    spl = SplitFlatIndex(ds.base)
    ids_e, _ = spl.search(ds.queries, 10, kb=16, cls=256, keep2=False)
    ids_a, _ = spl.search(
        ds.queries, 10, kb=16, cls=256, keep2=False, approx_sel=True
    )
    re = recall_at_k(ids_e, ds.ground_truth, 10)
    ra = recall_at_k(ids_a, ds.ground_truth, 10)
    assert ra >= re - 0.02, (re, ra)
    fast = FastFlatIndex(ds.base)
    ids_f, _ = fast.search(ds.queries, 10, kb=16, approx_sel=True)
    assert recall_at_k(ids_f, ds.ground_truth, 10) >= 0.95


def test_prerank_trim_helpers(rng):
    """prerank_trim_ext / prerank_trim_split pick exactly the best `pre`
    candidate ids under the stage-1 scores with (score, id) tie-breaks,
    and keep -1 pads out."""
    from shine_tpu.ops.distance import prerank_trim_ext, prerank_trim_split
    from shine_tpu.ops.packing import pack_ext_query, pack_ext_table
    from shine_tpu.ops.packing import comp_width, pack_split_tables

    n, d, B, K, pre = 512, 24, 16, 32, 8
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    cand = rng.integers(0, n, size=(B, K)).astype(np.int32)
    cand[:, -3:] = -1  # pads must never survive the trim
    # ext variant: score = <q_ext, ext[id]> in bf16
    ext = jnp.asarray(pack_ext_table(v, METRIC_L2, n))
    qe = pack_ext_query(jnp.asarray(q), ext.shape[1]).astype(jnp.bfloat16)
    got = np.asarray(prerank_trim_ext(ext, qe, jnp.asarray(cand), pre))
    scores = np.asarray(
        jnp.einsum("bd,bkd->bk", qe, ext[np.maximum(cand, 0)],
                   preferred_element_type=jnp.float32)
    )
    for b in range(B):
        order = sorted(
            range(K),
            key=lambda j: (
                (np.inf, 2**31 - 1, -1)
                if cand[b, j] < 0
                else (-scores[b, j], int(cand[b, j]), int(cand[b, j]))
            ),
        )
        want = [int(cand[b, j]) for j in order[:pre]]
        assert list(got[b]) == want, b
    assert (got >= 0).all()
    # split variant agrees with the dequantized exact stage-1 score
    comp, aux = pack_split_tables(v, METRIC_L2, n, comp_dtype=np.int8)
    got_s = np.asarray(
        prerank_trim_split(
            jnp.asarray(comp), jnp.asarray(aux), jnp.asarray(q),
            jnp.asarray(cand), pre,
        )
    )
    safe = np.maximum(cand, 0)
    dots = np.einsum(
        "bd,bkd->bk", q, comp[safe][..., :d].astype(np.float32)
    )
    sc = aux[1][safe] * dots + aux[0][safe]
    for b in range(B):
        order = sorted(
            range(K),
            key=lambda j: (
                (np.inf, 2**31 - 1)
                if cand[b, j] < 0
                else (-sc[b, j], int(cand[b, j]))
            ),
        )
        want = [int(cand[b, j]) for j in order[:pre]]
        assert list(got_s[b]) == want, b


def test_prerank_search_paths(rng):
    """prerank>0 end-to-end: the stage-1 trim keeps the exact re-rank's
    recall when the margin is generous, on both scan families and on the
    capacity regen path."""
    import jax

    from shine_tpu.io import recall_at_k, synthetic_dataset
    from shine_tpu.io.device_synth import regen_rows
    from shine_tpu.models.flat import FastFlatIndex, FlatIndex, SplitFlatIndex
    from shine_tpu.ops.packing import comp_width, pack_split_device

    ds = synthetic_dataset(n=6000, dim=48, num_queries=64, seed=7, gt_k=10)
    fast = FastFlatIndex(ds.base)
    ids0, dd0 = fast.search(ds.queries, 10, kb=16)
    ids1, dd1 = fast.search(ds.queries, 10, kb=16, prerank=16)
    r0 = recall_at_k(ids0, ds.ground_truth, 10)
    r1 = recall_at_k(ids1, ds.ground_truth, 10)
    assert r1 >= r0 - 0.02, (r0, r1)
    # where the trim kept the same id, the exact distance is unchanged
    match = ids0 == ids1
    np.testing.assert_allclose(dd1[match], dd0[match], rtol=0, atol=0)
    spl = SplitFlatIndex(ds.base)
    ids2, _ = spl.search(ds.queries, 10, kb=32, cls=256, keep2=False,
                         prerank=16)
    assert recall_at_k(ids2, ds.ground_truth, 10) >= 0.95
    # capacity regen path: trim before the threefry regeneration
    key = jax.random.PRNGKey(21)
    centers = jax.random.normal(
        jax.random.PRNGKey(2), (8, 32), jnp.float32
    ) * 4.0
    n, d = 4096, 32
    base = np.asarray(
        regen_rows(key, centers, jnp.arange(n, dtype=jnp.int32))
    )
    q = base[rng.integers(0, n, 48)] + 0.3 * rng.normal(
        size=(48, d)
    ).astype(np.float32)
    gt, _ = FlatIndex(base).search(q, 10)
    comp, aux = pack_split_device(
        jnp.asarray(base), metric=METRIC_L2, dpc=comp_width(d)
    )
    cap = SplitFlatIndex.from_parts(
        comp, aux, n, dim=d, row_source=(key, centers)
    )
    ids3, _ = cap.search(q, 10, kb=32, cls=256, keep2=False, prerank=16)
    assert recall_at_k(ids3, gt, 10) >= 0.97


def test_split_ip_metric(rng):
    from shine_tpu.io import recall_at_k, synthetic_dataset
    from shine_tpu.models.flat import SplitFlatIndex

    ds = synthetic_dataset(
        n=4096, dim=32, num_queries=48, seed=9, gt_k=10, metric="ip"
    )
    idx = SplitFlatIndex(ds.base, metric="ip")
    ids, _ = idx.search(ds.queries, 10, kb=16, cls=256, keep2=False)
    assert recall_at_k(ids, ds.ground_truth, 10) >= 0.95


def test_score_trim_matches_bruteforce(rng):
    """score_trim (the FREE prerank: sort candidates by in-hand stage-1
    scores) picks exactly the best `pre` ids with (score desc, id asc)
    tie-breaks and keeps -1 pads out — same contract as
    prerank_trim_ext given equal scores, minus the table re-read."""
    from shine_tpu.ops.distance import score_trim

    B, K, pre = 16, 32, 8
    vals = rng.normal(size=(B, K)).astype(np.float32)
    cand = rng.integers(0, 4096, size=(B, K)).astype(np.int32)
    cand[:, -3:] = -1
    vals[:, 5] = vals[:, 6]  # forced score ties: id breaks them
    got = np.asarray(score_trim(jnp.asarray(vals), jnp.asarray(cand), pre))
    for b in range(B):
        order = sorted(
            range(K),
            key=lambda j: (
                (np.inf, 2**31 - 1, -1)
                if cand[b, j] < 0
                else (-vals[b, j], int(cand[b, j]), int(cand[b, j]))
            ),
        )
        want = [int(cand[b, j]) for j in order[:pre]]
        assert list(got[b]) == want, b
    assert (got >= 0).all()


def test_fastflat_prerank_end_to_end(rng):
    """prerank>0 on the single-chip fastflat + split programs: the free
    score trim shrinks the exact re-rank set kb -> prerank without
    losing recall (the trim's precision equals the scan's own)."""
    from shine_tpu.io import recall_at_k, synthetic_dataset
    from shine_tpu.models.flat import FastFlatIndex, SplitFlatIndex

    ds = synthetic_dataset(n=4096, dim=32, num_queries=64, seed=11, gt_k=10)
    for cls_idx in (FastFlatIndex, SplitFlatIndex):
        idx = cls_idx(ds.base)
        base_i, _ = idx.search(ds.queries, 10, kb=32, batch_size=64)
        trim_i, _ = idx.search(
            ds.queries, 10, kb=32, batch_size=64, prerank=16
        )
        r0 = recall_at_k(base_i, ds.ground_truth, 10)
        r1 = recall_at_k(trim_i, ds.ground_truth, 10)
        assert r1 >= r0 - 0.03, (cls_idx.__name__, r0, r1)


def test_fastflat_megabatch_identity(rng):
    """megabatch=True (one lax.map program over the batch loop) is
    bit-identical to the per-batch dispatch path."""
    from shine_tpu.io import synthetic_dataset
    from shine_tpu.models.flat import FastFlatIndex

    ds = synthetic_dataset(n=4096, dim=32, num_queries=192, seed=7, gt_k=10)
    idx = FastFlatIndex(ds.base)
    kw = dict(k=10, kb=16, batch_size=64)
    loop_i, loop_d = idx.search(ds.queries, **kw)
    mega_i, mega_d = idx.search(ds.queries, megabatch=True, **kw)
    assert (loop_i == mega_i).all()
    assert np.array_equal(loop_d, mega_d)


def test_search_device_matches_host(rng):
    """search_device (device-resident results, on-device perm remap) is
    bit-identical to search() in both dispatch modes — the r4 headline
    methodology depends on this identity (bench fastflat_sustained_
    mega_dev row)."""
    from shine_tpu.io import synthetic_dataset
    from shine_tpu.models.flat import FastFlatIndex

    ds = synthetic_dataset(n=4096, dim=32, num_queries=192, seed=11,
                           gt_k=10)
    idx = FastFlatIndex(ds.base)  # shuffle on: perm path
    assert idx.perm is not None
    kw = dict(kb=16, batch_size=64)
    host_i, host_d = idx.search(ds.queries, 10, **kw)
    pre = idx.preload(ds.queries, batch_size=64)
    for mega in (False, True):
        ii, dd = idx.search_device(pre, 10, megabatch=mega, **kw)
        np.testing.assert_array_equal(np.asarray(ii), host_i)
        np.testing.assert_allclose(np.asarray(dd), host_d, rtol=1e-6)


def test_split_megabatch_identity(rng):
    """SplitFlatIndex megabatch=True is bit-identical to the loop path."""
    from shine_tpu.io import synthetic_dataset
    from shine_tpu.models.flat import SplitFlatIndex

    ds = synthetic_dataset(n=4096, dim=32, num_queries=192, seed=9, gt_k=10)
    idx = SplitFlatIndex(ds.base)
    kw = dict(k=10, kb=16, batch_size=64, cls=256)
    loop_i, loop_d = idx.search(ds.queries, **kw)
    mega_i, mega_d = idx.search(ds.queries, megabatch=True, **kw)
    assert (loop_i == mega_i).all()
    assert np.array_equal(loop_d, mega_d)
