"""Brute-force k-NN oracle and recall@k.

Recall is the reference's correctness oracle
(/root/reference/src/compute_node.cc:578-600): for each query, the fraction
of returned ids that appear in the true top-k. Brute force runs as chunked
matmuls so it can use the accelerator (or CPU BLAS) for large sets.
"""

from __future__ import annotations

import numpy as np

from shine_tpu.config import METRIC_IP, metric_id


def brute_force_knn(
    base: np.ndarray,
    queries: np.ndarray,
    k: int,
    *,
    metric: str | int = "l2",
    chunk: int = 65536,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k. Returns (ids (q,k) int32, dists (q,k) float32).

    L2 is squared; IP distance is 1 - <a,b>, matching the reference
    conventions (/root/reference/src/hnsw/distance.hh:80-151,139).
    Ties break by ascending id like the reference heap
    (/root/reference/src/hnsw/heap.hh:53-57).
    """
    mid = metric_id(metric)
    q = queries.astype(np.float32)
    nq = q.shape[0]
    n = base.shape[0]
    k = min(k, n)
    best_d = np.full((nq, k), np.inf, dtype=np.float32)
    best_i = np.full((nq, k), -1, dtype=np.int64)
    qn = (q * q).sum(axis=1, keepdims=True)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        blk = base[lo:hi].astype(np.float32)
        dots = q @ blk.T
        if mid == METRIC_IP:
            d = 1.0 - dots
        else:
            bn = (blk * blk).sum(axis=1)
            d = qn - 2.0 * dots + bn[None, :]
        ids = np.arange(lo, hi, dtype=np.int64)[None, :].repeat(nq, axis=0)
        all_d = np.concatenate([best_d, d], axis=1)
        all_i = np.concatenate([best_i, ids], axis=1)
        # stable top-k with (dist, id) ordering
        part = np.argpartition(all_d, k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(all_d, part, axis=1)
        pi = np.take_along_axis(all_i, part, axis=1)
        order = np.lexsort((pi, pd), axis=1)
        best_d = np.take_along_axis(pd, order, axis=1)
        best_i = np.take_along_axis(pi, order, axis=1)
    return best_i.astype(np.int32), best_d


def recall_at_k(found_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    """Mean |found[:k] ∩ gt[:k]| / k over queries.

    Vectorized (k is small, so the (chunk, k, k) membership tile is cheap);
    the per-query Python sets of the first version were 50x too slow at the
    reference's 500k-query workloads (scripts/data/create_queries.py:5).
    Row counts may differ (e.g. --num-queries caps the found rows); recall
    is computed over the common prefix and normalized by it.
    """
    found = np.asarray(found_ids)[:, :k]
    gt = np.asarray(gt_ids)[:, :k]
    nq = min(found.shape[0], gt.shape[0])
    if nq == 0:
        return 0.0
    found, gt = found[:nq].astype(np.int64), gt[:nq].astype(np.int64)
    hits = 0
    chunk = 65536
    for lo in range(0, nq, chunk):
        hi = min(lo + chunk, nq)
        m = found[lo:hi, :, None] == gt[lo:hi, None, :]
        hits += int(m.any(axis=2).sum())
    return hits / (nq * k)


def recall_at_k_eps(
    found_ids: np.ndarray,
    queries,
    base_dev,
    gt_ids: np.ndarray,
    k: int,
    *,
    rtol: float = 1e-4,
    batch: int = 2048,
) -> float:
    """Distance-tolerance recall: the fraction of returned rows whose
    exact distance is within (1+rtol) of the true k-th neighbor's.

    Id-based recall punishes near-ties that are physically
    indistinguishable: at 10M synthetic rows the gap between the 10th
    and 11th neighbor is far below bf16 scan precision, capping id
    recall at ~0.91 while every returned row is within 1e-4 of optimal.
    Big-ann-benchmarks reports the same metric as
    an alternative for exactly this reason. Distances are computed
    exactly (f32) on device against the device-resident base.
    """
    import jax
    import jax.numpy as jnp

    found = np.asarray(found_ids)[:, :k]
    gt = np.asarray(gt_ids)[:, :k]
    nq = min(found.shape[0], gt.shape[0], len(queries))
    found, gt = found[:nq], gt[:nq]

    @jax.jit
    def dists(base, q, ids):
        # base is an argument, NOT a closure capture: a captured device
        # array becomes a compile-time constant and a 5 GB base hangs the
        # compile (measured; the jax captured-constants warning fires)
        v = base[jnp.maximum(ids, 0)].astype(jnp.float32)  # (b, k, d)
        qf = q.astype(jnp.float32)
        dd = jnp.sum((v - qf[:, None, :]) ** 2, axis=-1)
        return jnp.where(ids >= 0, dd, jnp.inf)

    ok = 0
    for lo in range(0, nq, batch):
        hi = min(lo + batch, nq)
        q = jnp.asarray(np.asarray(queries[lo:hi], np.float32))
        df = np.asarray(dists(base_dev, q, jnp.asarray(found[lo:hi])))
        dg = np.asarray(dists(base_dev, q, jnp.asarray(gt[lo:hi])))
        thresh = np.sort(dg, axis=1)[:, k - 1] * (1.0 + rtol) + 1e-12
        ok += int((df <= thresh[:, None]).sum())
    return ok / (nq * k)


def recall_at_k_eps_regen(
    found_ids: np.ndarray,
    queries,
    row_source,
    gt_ids: np.ndarray,
    k: int,
    *,
    rtol: float = 1e-4,
    batch: int = 2048,
) -> float:
    """recall_at_k_eps for row-keyed datasets: exact rows are
    REGENERATED from (key, centers) by global id
    (io/device_synth.py:regen_rows) instead of gathered from a resident
    f32 base — scores capacity-scale results where the base never fits
    HBM (41.9M rows f32 = 21.5 GB on a 16 GB chip). Same tolerance
    semantics as recall_at_k_eps; L2 only (the capacity studies'
    metric)."""
    import jax
    import jax.numpy as jnp

    from shine_tpu.io.device_synth import regen_rows

    rkey, centers = row_source
    found = np.asarray(found_ids)[:, :k]
    gt = np.asarray(gt_ids)[:, :k]
    nq = min(found.shape[0], gt.shape[0], len(queries))
    found, gt = found[:nq], gt[:nq]

    @jax.jit
    def dists(q, ids):
        # centers is a (num_clusters, d) constant — tiny, safe to close
        # over (the captured-constant hazard is multi-GB bases)
        flat = jnp.maximum(ids, 0).reshape(-1)
        v = regen_rows(rkey, centers, flat).reshape(
            ids.shape + (centers.shape[1],)
        )
        qf = q.astype(jnp.float32)
        dd = jnp.sum((v - qf[:, None, :]) ** 2, axis=-1)
        return jnp.where(ids >= 0, dd, jnp.inf)

    ok = 0
    for lo in range(0, nq, batch):
        hi = min(lo + batch, nq)
        q = jnp.asarray(np.asarray(queries[lo:hi], np.float32))
        df = np.asarray(dists(q, jnp.asarray(found[lo:hi])))
        dg = np.asarray(dists(q, jnp.asarray(gt[lo:hi])))
        thresh = np.sort(dg, axis=1)[:, k - 1] * (1.0 + rtol) + 1e-12
        ok += int((df <= thresh[:, None]).sum())
    return ok / (nq * k)


def margin_mask(
    queries,
    base_dev,
    gt_ids: np.ndarray,
    k: int,
    *,
    rtol: float = 1e-4,
    batch: int = 2048,
    row_source=None,
) -> np.ndarray:
    """Bool (nq,): queries whose top-k boundary is REAL — the exact
    (k+1)-th distance exceeds (1+rtol) x the k-th. gt_ids needs >= k+1
    columns (ask the dataset for gt_k=k+1).

    This turns the recurring near-tie caveat into a measurement: on
    synthetic iid data at d=128 the 10th/11th neighbor gap concentrates
    below bf16 scan precision, so id-recall is capped by physically
    indistinguishable swaps. Restricting id-recall to margin queries
    (`recall_at_k(found[m], gt[m], k)`) shows the search itself is
    exact where the data has an answer; `1 - mask.mean()` is the
    measured artifact rate. Distances are exact f32 on device, against
    a resident base (base_dev) or a row-keyed source (row_source=(key,
    centers), base_dev ignored). Because the mask only needs GT +
    queries, it can be computed while the base is still resident and
    applied to any later search's ids (scale_10m_hnsw frees the base
    before serving)."""
    import jax
    import jax.numpy as jnp

    gt = np.asarray(gt_ids)[:, : k + 1]
    assert gt.shape[1] == k + 1, "margin_mask needs gt_k >= k+1"
    nq = min(gt.shape[0], len(queries))
    gt = gt[:nq]

    if row_source is not None:
        from shine_tpu.io.device_synth import regen_rows

        rkey, centers = row_source

        @jax.jit
        def dists(q, ids):
            flat = jnp.maximum(ids, 0).reshape(-1)
            v = regen_rows(rkey, centers, flat).reshape(
                ids.shape + (centers.shape[1],)
            )
            dd = jnp.sum((v - q.astype(jnp.float32)[:, None, :]) ** 2,
                         axis=-1)
            return jnp.where(ids >= 0, dd, jnp.inf)

        dfn = dists
    else:

        @jax.jit
        def dists(base, q, ids):
            # base as argument, not closure (captured-constant hazard)
            v = base[jnp.maximum(ids, 0)].astype(jnp.float32)
            dd = jnp.sum((v - q.astype(jnp.float32)[:, None, :]) ** 2,
                         axis=-1)
            return jnp.where(ids >= 0, dd, jnp.inf)

        def dfn(q, ids):
            return dists(base_dev, q, ids)

    out = np.empty(nq, bool)
    for lo in range(0, nq, batch):
        hi = min(lo + batch, nq)
        q = jnp.asarray(np.asarray(queries[lo:hi], np.float32))
        dg = np.sort(np.asarray(dfn(q, jnp.asarray(gt[lo:hi]))), axis=1)
        out[lo:hi] = dg[:, k] > dg[:, k - 1] * (1.0 + rtol) + 1e-12
    return out


def numpy_subset_gt(
    queries: np.ndarray, base: np.ndarray, k: int = 10, *,
    chunk: int = 131072, metric: str | int = "l2",
) -> np.ndarray:
    """Exact ground truth in pure numpy — the platform-independent
    scorer oracle. Chunked running top-32 with (dist, id) tie-break
    (identical to every device path's ordering). Slow (~2 GFLOP/s host
    BLAS) — size the query subset accordingly.

    Reference role: recall is the reference's correctness oracle
    (compute_node.cc:578-600) — which is only an oracle if the GT is
    right. A DEFAULT-precision matmul truncating the f32 GT leg to
    bf16 grade once proved device-side GT can corrupt while every
    device-side instrument (margin/eps) consumes the same distances and
    stays blind; this numpy twin is the independent witness."""
    m = metric_id(metric)
    q = queries.astype(np.float32)
    ne = len(q)
    keep = max(32, k)
    bn = (base.astype(np.float32) ** 2).sum(axis=1)
    best_d = np.full((ne, keep), np.inf, np.float32)
    best_i = np.full((ne, keep), -1, np.int64)
    for lo in range(0, len(base), chunk):
        hi = min(lo + chunk, len(base))
        dots = q @ base[lo:hi].astype(np.float32).T
        if m == METRIC_IP:
            dd = 1.0 - dots
        else:
            dd = -2.0 * dots + bn[lo:hi]
        ids = np.arange(lo, hi, dtype=np.int64)[None, :].repeat(ne, axis=0)
        ad = np.concatenate([best_d, dd], axis=1)
        ai = np.concatenate([best_i, ids], axis=1)
        part = np.argpartition(ad, keep - 1, axis=1)[:, :keep]
        pd = np.take_along_axis(ad, part, axis=1)
        pi = np.take_along_axis(ai, part, axis=1)
        order = np.lexsort((pi, pd), axis=1)
        best_d = np.take_along_axis(pd, order, axis=1)
        best_i = np.take_along_axis(pi, order, axis=1)
    return best_i[:, :k]


def gt_crosscheck(
    queries: np.ndarray, base: np.ndarray, gt_dev: np.ndarray,
    k: int = 10, *, n_eval: int = 256, chunk: int = 131072,
    metric: str | int = "l2",
) -> float:
    """Overlap of the device-computed ground truth with the exact numpy
    oracle on a query subset. 1.0 certifies the scorer; anything below
    ~0.999 on synthetic data means the GT pipeline itself is corrupt
    (see numpy_subset_gt docstring — the r4 precision incident). Every
    scale script emits this as a gt_overlap column so a scorer-class
    bug caps one run, not a round of readings."""
    ne = min(n_eval, len(queries), len(gt_dev))
    gt_np = numpy_subset_gt(queries[:ne], base, k, chunk=chunk,
                            metric=metric)
    return recall_at_k(np.asarray(gt_dev)[:ne], gt_np, k)
