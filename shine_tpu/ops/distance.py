"""Distance computations.

Replacement for the reference's AVX2 kernels
(/root/reference/src/hnsw/distance.hh:11-76): instead of 16-lane SIMD strips
over one (query, point) pair at a time, distances are computed for whole
tiles of queries × candidates as matmuls using the
``||a-b||^2 = ||a||^2 - 2<a,b> + ||b||^2`` expansion, and inner-product
distance as ``1 - <a,b>`` (reference distance.hh:139). L2 is squared, like
the reference (distance.hh:80-118).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from shine_tpu.config import METRIC_IP, METRIC_L2

# Distances drive ranking decisions; JAX's DEFAULT matmul precision may
# run f32 operands at bf16 or TF32 grade, which shifts recall. HIGHEST
# keeps full f32 (never TF32) for every ranking product.
DIST_PRECISION = jax.lax.Precision.HIGHEST


def squared_norms(x: jnp.ndarray) -> jnp.ndarray:
    """Exact f32 squared norms via an explicit HIGHEST-precision
    self-contraction. `jnp.sum(x * x)` is algebraically identical, but
    XLA may rewrite a reduce-of-multiply as a self-dot at DEFAULT
    precision (reduced-precision f32 operands) — a silent downcast that
    once corrupted device ground truth. Every norm that participates in
    a RANKING across rows must
    ride this helper; per-query norms are rank-invariant offsets and
    may use plain sums."""
    x = x.astype(jnp.float32)
    return jnp.einsum(
        "...d,...d->...", x, x,
        precision=DIST_PRECISION, preferred_element_type=jnp.float32,
    )


def l2_rows(q: jnp.ndarray, rows: jnp.ndarray) -> jnp.ndarray:
    """Squared L2 between q (..., d) and its gathered rows (..., K, d) as
    a sum of squared differences. Unlike |q|^2 - 2<q,v> + |v|^2 it has no
    cancellation (which costs ~1e-5 relative at d=128), so two code paths
    that gather the same rows — single-device and sharded traversal —
    agree to the last bits and rank near-ties alike. The square is an
    explicit HIGHEST contraction, like squared_norms."""
    diff = rows.astype(jnp.float32) - q.astype(jnp.float32)[..., None, :]
    return jnp.einsum(
        "...kd,...kd->...k", diff, diff,
        precision=DIST_PRECISION, preferred_element_type=jnp.float32,
    )


def pairwise_distance(
    queries: jnp.ndarray,  # (B, d)
    points: jnp.ndarray,  # (N, d)
    metric: int = METRIC_L2,
    *,
    points_sqnorm: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Full (B, N) distance tile — one big matmul."""
    q = queries.astype(jnp.float32)
    p = points.astype(jnp.float32)
    dots = jax.lax.dot_general(
        q,
        p,
        (((1,), (1,)), ((), ())),
        precision=DIST_PRECISION,
        preferred_element_type=jnp.float32,
    )
    if metric == METRIC_IP:
        return 1.0 - dots
    pn = points_sqnorm if points_sqnorm is not None else squared_norms(p)
    qn = squared_norms(q)
    return qn[:, None] - 2.0 * dots + pn[None, :]


def rerank_topk(
    vectors: jnp.ndarray,  # (N, d) f32
    sqnorms: jnp.ndarray,  # (N,) f32
    queries: jnp.ndarray,  # (..., d) f32
    cand_ids: jnp.ndarray,  # (..., K) i32, -1 pad
    k: int,
    metric: int = METRIC_L2,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact f32 re-ranking of K candidates down to k.

    The recall-recovery step after a bf16 scan: bf16 rounding can
    reorder near-ties, so scans over-retrieve K = O(4k) and this picks the
    true top-k at full precision. Returns (dists (..., k), ids (..., k))
    sorted ascending with the (dist, id) tie-break (reference
    heap.hh:53-57)."""
    q = queries.astype(jnp.float32)
    safe = jnp.maximum(cand_ids, 0)
    cv = vectors[safe]
    dots = jnp.einsum(
        "...d,...kd->...k", q, cv, precision=DIST_PRECISION,
        preferred_element_type=jnp.float32,
    )
    if metric == METRIC_IP:
        d = 1.0 - dots
    else:
        qn = jnp.sum(q * q, axis=-1)
        d = qn[..., None] - 2.0 * dots + sqnorms[safe]
    d = jnp.where(cand_ids >= 0, d, jnp.inf)
    key_i = jnp.where(cand_ids < 0, jnp.int32(2**31 - 1), cand_ids)
    d, _, ids = jax.lax.sort(
        (d, key_i, cand_ids), dimension=-1, num_keys=2
    )
    return d[..., :k], ids[..., :k]


def rerank_topk_ext(
    ext: jnp.ndarray,  # (N_pad, dp) bf16 packed score table
    queries: jnp.ndarray,  # (..., d) f32
    cand_ids: jnp.ndarray,  # (..., K) i32, -1 pad
    k: int,
    metric: int = METRIC_L2,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Re-rank straight from the packed bf16 score table — the capacity
    mode where the f32 base is NOT device-resident (ext rows hold
    [2v | -||v||^2] for L2, [v] for IP; ops/packing.py).
    distance = ||q||^2 - score (L2) or 1 - score (IP). Precision is the
    bf16 row storage (~0.4% relative) — same noise class as the scan
    itself, so ordering among true near-ties is approximate; use
    rerank_topk when the f32 base is available."""
    from shine_tpu.ops.packing import pack_ext_query

    q = queries.astype(jnp.float32)
    qe = pack_ext_query(q.reshape(-1, q.shape[-1]), ext.shape[1])
    qe = qe.reshape(q.shape[:-1] + (ext.shape[1],))
    safe = jnp.maximum(cand_ids, 0)
    rows = ext[safe]  # (..., K, dp) bf16
    scores = jnp.einsum(
        "...d,...kd->...k", qe.astype(jnp.bfloat16), rows,
        preferred_element_type=jnp.float32,
    )
    if metric == METRIC_IP:
        d = 1.0 - scores
    else:
        qn = jnp.sum(q * q, axis=-1)
        d = qn[..., None] - scores
    d = jnp.where(cand_ids >= 0, d, jnp.inf)
    key_i = jnp.where(cand_ids < 0, jnp.int32(2**31 - 1), cand_ids)
    d, _, ids = jax.lax.sort(
        (d, key_i, cand_ids), dimension=-1, num_keys=2
    )
    return d[..., :k], ids[..., :k]


def rerank_topk_split(
    comp: jnp.ndarray,  # (N_pad, dpc) bf16 or int8 component table
    aux: jnp.ndarray,  # (2, N_pad) f32: [0]=nrm, [1]=scl
    queries: jnp.ndarray,  # (..., d) f32
    cand_ids: jnp.ndarray,  # (..., K) i32, -1 pad
    k: int,
    metric: int = METRIC_L2,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Re-rank from the split-layout tables (ops/packing.py)
    when no f32 base is resident: distance = ||q||^2 - score with
    score = scl[id] * <q, comp[id]> + nrm[id]. Precision is the component
    storage (bf16 ~0.4%, int8 per-row ~s/127); use regen_rerank_topk for
    exact re-ranking when the base is row-keyed."""
    q = queries.astype(jnp.float32)
    d = q.shape[-1]
    safe = jnp.maximum(cand_ids, 0)
    rows = comp[safe][..., :d].astype(jnp.float32)  # (..., K, d)
    dots = jnp.einsum(
        "...d,...kd->...k", q, rows, precision=DIST_PRECISION,
        preferred_element_type=jnp.float32,
    )
    scores = aux[1][safe] * dots + aux[0][safe]
    if metric == METRIC_IP:
        dd = 1.0 - scores
    else:
        qn = jnp.sum(q * q, axis=-1)
        dd = qn[..., None] - scores
    dd = jnp.where(cand_ids >= 0, dd, jnp.inf)
    key_i = jnp.where(cand_ids < 0, jnp.int32(2**31 - 1), cand_ids)
    dd, _, ids = jax.lax.sort(
        (dd, key_i, cand_ids), dimension=-1, num_keys=2
    )
    return dd[..., :k], ids[..., :k]


def score_trim(
    vals: jnp.ndarray,  # (..., K) f32 stage-1 scores (higher = closer)
    cand_ids: jnp.ndarray,  # (..., K) i32, -1 pad
    pre: int,
) -> jnp.ndarray:
    """The FREE prerank: trim candidates to the best `pre` using scores
    already in hand. The class-max scan kernels return the bf16-accumulated
    score of every selected candidate (fused v5 epilogue, or the top_k
    values on the unfused path), so the kb -> pre trim before the exact
    re-rank needs no HBM gather and no re-scoring — prerank_trim_ext /
    prerank_trim_split re-read K rows from the resident tables to recompute
    exactly this number. A (B, K) three-key sort replaces that round trip.
    Tie-break (score desc, id asc) matches the trim helpers given equal
    scores; -1 padding sorts last."""
    sd = jnp.where(cand_ids >= 0, -vals.astype(jnp.float32), jnp.inf)
    key_i = jnp.where(cand_ids < 0, jnp.int32(2**31 - 1), cand_ids)
    _, _, ids = jax.lax.sort(
        (sd, key_i, cand_ids), dimension=-1, num_keys=2
    )
    return ids[..., :pre]


def prerank_trim_ext(
    ext: jnp.ndarray,  # (N_pad, dp) bf16 packed score table
    q_ext: jnp.ndarray,  # (B, dp) packed extended queries
    cand_ids: jnp.ndarray,  # (B, K) i32, -1 pad
    pre: int,
) -> jnp.ndarray:
    """Stage-1 candidate trim: score the kb survivors straight from the
    HBM-resident bf16 scan table and keep only the best `pre` before the
    expensive exact re-rank (f32 row gather or PRNG regen). The gather +
    re-rank tail can cost more than the scan in a small-N dispatch;
    shrinking K -> pre shrinks both terms. Precision of the trim is the bf16 row storage —
    the same noise class as the scan that picked the candidates, so a
    pre >= ~1.5k margin keeps the exact stage's recall. Ties break
    (score, id) ascending like every other stage."""
    safe = jnp.maximum(cand_ids, 0)
    rows = ext[safe]  # (B, K, dp) bf16
    scores = jnp.einsum(
        "...d,...kd->...k", q_ext.astype(jnp.bfloat16), rows,
        preferred_element_type=jnp.float32,
    )
    sd = jnp.where(cand_ids >= 0, -scores, jnp.inf)
    key_i = jnp.where(cand_ids < 0, jnp.int32(2**31 - 1), cand_ids)
    _, _, ids = jax.lax.sort(
        (sd, key_i, cand_ids), dimension=-1, num_keys=2
    )
    return ids[..., :pre]


def prerank_trim_split(
    comp: jnp.ndarray,  # (N_pad, dpc) bf16 or int8 component table
    aux: jnp.ndarray,  # (2, N_pad) f32: [0]=nrm, [1]=scl
    queries: jnp.ndarray,  # (B, d) f32
    cand_ids: jnp.ndarray,  # (B, K) i32, -1 pad
    pre: int,
) -> jnp.ndarray:
    """prerank_trim_ext for the split layout: stage-1 scores from the
    component table + (nrm, scl) aux row, keep the best `pre` candidate
    ids for the exact stage (rerank_topk / regen_rerank_topk)."""
    q = queries.astype(jnp.float32)
    d = q.shape[-1]
    safe = jnp.maximum(cand_ids, 0)
    rows = comp[safe][..., :d].astype(jnp.float32)
    dots = jnp.einsum(
        "...d,...kd->...k", q, rows, precision=DIST_PRECISION,
        preferred_element_type=jnp.float32,
    )
    scores = aux[1][safe] * dots + aux[0][safe]
    sd = jnp.where(cand_ids >= 0, -scores, jnp.inf)
    key_i = jnp.where(cand_ids < 0, jnp.int32(2**31 - 1), cand_ids)
    _, _, ids = jax.lax.sort(
        (sd, key_i, cand_ids), dimension=-1, num_keys=2
    )
    return ids[..., :pre]


def candidate_distance(
    queries: jnp.ndarray,  # (B, d)
    cand_vecs: jnp.ndarray,  # (B, K, d) gathered candidate rows
    metric: int = METRIC_L2,
    *,
    cand_sqnorm: jnp.ndarray | None = None,  # (B, K)
) -> jnp.ndarray:
    """Per-query candidate distances (B, K).

    This is the hot op of graph traversal: each query has its own K gathered
    neighbor vectors (the analogue of the per-neighbor RDMA READ + AVX
    distance in the reference's search_level, hnsw.hh:440-467). Batched
    matvec over B; HBM gather bandwidth, not FLOPs, is the bottleneck.
    """
    q = queries.astype(jnp.float32)
    c = cand_vecs.astype(jnp.float32)
    dots = jnp.einsum(
        "bd,bkd->bk",
        q,
        c,
        precision=DIST_PRECISION,
        preferred_element_type=jnp.float32,
    )
    if metric == METRIC_IP:
        return 1.0 - dots
    cn = cand_sqnorm if cand_sqnorm is not None else squared_norms(c)
    qn = squared_norms(q)
    return qn[:, None] - 2.0 * dots + cn


def regen_rerank_topk(
    key,  # PRNG key of the row-keyed synthetic base
    centers: jnp.ndarray,  # (nc, d) f32 mixture centers
    queries: jnp.ndarray,  # (..., d) f32
    cand_ids: jnp.ndarray,  # (..., K) i32 global row ids, -1 pad
    k: int,
    metric: int = METRIC_L2,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """EXACT f32 re-rank without a resident base: candidate rows are
    regenerated from their global ids (io/device_synth.py:regen_rows — a
    row is a pure function of fold_in(key, id)), so capacity-mode search
    (FastFlatIndex.from_ext) recovers exact-re-rank recall at zero extra
    HBM. Cost is O(K) threefry + one (B, K, d) einsum per batch — the
    same shape as rerank_topk's gather, compute instead of memory."""
    from shine_tpu.io.device_synth import regen_rows

    q = queries.astype(jnp.float32)
    shape = cand_ids.shape
    safe = jnp.maximum(cand_ids, 0).reshape(-1)
    rows = regen_rows(
        key, centers, safe, normalize=(metric == METRIC_IP)
    ).reshape(shape + (q.shape[-1],))
    dots = jnp.einsum(
        "...d,...kd->...k", q, rows,
        precision=DIST_PRECISION, preferred_element_type=jnp.float32,
    )
    if metric == METRIC_IP:
        d = 1.0 - dots
    else:
        qn = jnp.sum(q * q, axis=-1)  # per-query: rank-invariant offset
        rn = squared_norms(rows)  # per-row: ranks across candidates
        d = qn[..., None] - 2.0 * dots + rn
    d = jnp.where(cand_ids >= 0, d, jnp.inf)
    key_i = jnp.where(cand_ids < 0, jnp.int32(2**31 - 1), cand_ids)
    d, _, ids = jax.lax.sort(
        (d, key_i, cand_ids), dimension=-1, num_keys=2
    )
    return d[..., :k], ids[..., :k]
