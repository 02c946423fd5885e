"""Routed (cluster-pruned) serving over the SPLIT capacity layout.

The flat split scan reads every row per batch, so its cost grows with
the table. This module trades exactness-by-sweep for
exactness-by-re-rank over a PRUNED candidate set: rows are clustered
(balanced k-means, the capacity_assign scheme shared with models/ivf.py
and parallel/placement.py), stored cluster-major in the 136 B/row int8
split layout, and a batch probes only its tiles' top clusters — the
affinity-routed tile-shared union of ivf_routed_search
(models/ivf.py:457) reapplied to the capacity tables, with the EXACT
regen re-rank (ops/distance.py:regen_rerank_topk) restoring f32
precision on the survivors.

The scan (scan_select) gathers each tile's granted cluster blocks and
runs one bf16 einsum over them plus the class-max reduce, in XLA.

Reference role: the reference serves its 100M envelope by pruning
traversal to ~ef*M rows via the HNSW graph (hnsw.hh:253-307) over
5 MNs x 44 GB (memory_node.hh:112-125); here the pruning is coarse
clusters + matmul block scans, sized so ONE device holds the whole
envelope.
Routing parity: query->CN affinity batching (query_router.hh:353-370).

Ingestion never materializes the f32 base: cluster assignment streams
over regenerated row chunks (row-keyed PRNG datasets,
io/device_synth.py:regen_rows), and the cluster-major tables are packed
by streaming the PERMUTED id order through the same split packer the
flat ingest uses (pack_split_device). Exact ground truth can be folded
during the ingest stream exactly as device_rowkeyed_split_dataset does.
"""

from __future__ import annotations

import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from shine_tpu.config import METRIC_L2, metric_id

NEG = -3e38


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def _make_rowfn(row_source, base_dev, metric: int):
    """Row provider: global ids (m,) i32 -> (m, d) f32 rows.

    row_source=(key, centers) regenerates rows from the PRNG (capacity
    mode — nothing resident); base_dev serves small device-resident
    bases (tests, <=10M-class)."""
    if row_source is not None:
        from shine_tpu.io.device_synth import regen_rows

        key, centers = row_source

        def rowfn(ids):
            return regen_rows(
                key, centers, ids, normalize=(metric != METRIC_L2)
            )

        return rowfn
    assert base_dev is not None, "need row_source or base_dev"

    def rowfn(ids):
        return base_dev[ids].astype(jnp.float32)

    return rowfn


def _route_cols(probes_s, C: int, P: int):
    """Rank-major tile-shared column grant, sort-based (no scatter).

    probes_s: (G, T, p) per-query probe wishes, affinity-sorted. Every
    query gets its rank-r wish considered before any query's rank r+1
    (the balanced-batch fairness of query_router.hh:353-370): wish
    (t, r) carries position r*T + t, each cluster's priority is its
    minimum position, and the P best-priority clusters win. Returns
    (cols (G, P) i32 with invalid = C [the pad cluster], coverage
    scalar = granted wish fraction). Two (G, T*p) sorts replace the
    (G, C) scatter-min of the first implementation."""
    G, T, p = probes_s.shape
    TP = T * p
    pos = jnp.broadcast_to(
        jnp.arange(TP, dtype=jnp.int32).reshape(p, T).T, (G, T, p)
    ).reshape(G, TP)
    comb = probes_s.reshape(G, TP) * TP + pos
    s = jnp.sort(comb, axis=1)
    k_s = s // TP
    pos_s = s % TP
    iota = jnp.broadcast_to(jnp.arange(TP, dtype=jnp.int32), (G, TP))
    is_first = jnp.concatenate(
        [jnp.ones((G, 1), bool), k_s[:, 1:] != k_s[:, :-1]], axis=1
    )
    seg_start = jax.lax.cummax(jnp.where(is_first, iota, 0), axis=1)
    minpos_elem = jnp.take_along_axis(pos_s, seg_start, axis=1)
    # second sort: unique clusters by their min position
    val = jnp.where(is_first, pos_s, TP)  # TP = +inf sentinel
    s2 = jnp.sort(val * (C + 1) + k_s, axis=1)[:, :P]
    val2 = s2 // (C + 1)
    cols = jnp.where(val2 < TP, s2 % (C + 1), C)
    # positions are unique per group, so "minpos <= P-th unique minpos"
    # selects exactly the granted clusters' wishes
    thresh = jnp.where(val2[:, -1:] < TP, val2[:, -1:], TP)
    granted_sorted = minpos_elem <= thresh
    coverage = granted_sorted.mean()
    # per-query granted fraction (affinity-sorted order): scatter each
    # sorted wish's verdict back to its (rank, query) position — drives
    # the per-query fallback spill (ivf.py search_routed analogue)
    g_flat = jnp.zeros((G, TP), jnp.float32).at[
        jnp.arange(G, dtype=jnp.int32)[:, None], pos_s
    ].set(granted_sorted.astype(jnp.float32))
    q_granted = g_flat.reshape(G, p, T).mean(axis=1).reshape(G * T)
    return cols, coverage, q_granted


class RoutedSplitIndex:
    """Cluster-pruned capacity serving: balanced-k-means split tables +
    tile-shared probing + exact regen re-rank. Build via
    `build_routed_split`."""

    def __init__(
        self,
        centroids,  # (C, d) f32
        comp,  # ((C+1)*cap, dpc) int8|bf16 cluster-major (+1 pad cluster)
        aux_r,  # (C+1, 2*members, cls) f32 nrm rows then scl rows
        gid,  # ((C+1)*cap,) i32 global row id, -1 pad
        n: int,
        dim: int,
        metric: int,
        *,
        cls: int,
        cap: int | None = None,
        row_source=None,
        base_dev=None,
        sqnorms=None,
    ):
        self.centroids = centroids
        self.comp = comp
        self.aux_r = aux_r
        self.gid = gid
        self.n, self.dim = n, dim
        self.metric = metric
        self.cls = cls
        self.row_source = row_source
        self.base_dev = base_dev
        self.sqnorms = sqnorms
        self.C = int(centroids.shape[0])
        # comp may carry ingest-pad rows past (C+1)*cap (gid -1, never
        # addressed by the kernel: cols <= C) — slicing them off would
        # double-buffer the largest HBM array, the r3c 100M OOM
        self.cap = int(cap) if cap is not None else (
            int(comp.shape[0]) // (self.C + 1)
        )
        self.last_coverage = None
        self.last_fallback = 0

    def recenter_routing(self, *, chunk: int = 262_144) -> None:
        """Replace each ROUTING centroid with the mean of the cluster's
        assigned members (regenerated exactly by gid — works on loaded
        checkpoints, no re-ingest).

        Rationale: query probes rank clusters by d(q, centroid), but
        capacity assignment displaces rows off their Lloyd-nearest
        cluster (fill 0.95 at 100M), so the Lloyd centroid no longer
        describes what the cluster HOLDS. Serving re-ranks exactly, so
        this only moves probe targets; recall effect must be measured
        per scale (a small-scale A/B at fill 0.8 / assignment-rank
        r0=1.0 was a wash — the hypothesis lives in the 100M
        displacement regime, scale_capacity_routed.jsonl p=128 plateau
        at coverage 1.0)."""
        rowfn = _make_rowfn(self.row_source, self.base_dev, self.metric)
        C, cap, d = self.C, self.cap, int(self.centroids.shape[1])
        total = (C + 1) * cap
        while chunk > cap and total % chunk:
            chunk //= 2
        sub = math.gcd(min(8192, chunk), chunk)
        gid_dev = self.gid

        @jax.jit
        def fold(lo, sums, counts):
            def body(carry, s):
                sm, ct = carry
                ids = jax.lax.dynamic_slice_in_dim(gid_dev, s, sub, 0)
                valid = (ids >= 0).astype(jnp.float32)
                x = rowfn(jnp.maximum(ids, 0)).astype(jnp.float32)
                cl = (s + jnp.arange(sub, dtype=jnp.int32)) // cap
                cl = jnp.minimum(cl, C)  # pad cluster folds to slot C
                sm = sm.at[cl].add(x * valid[:, None])
                ct = ct.at[cl].add(valid)
                return (sm, ct), None

            starts = lo + jnp.arange(chunk // sub, dtype=jnp.int32) * sub
            (sums, counts), _ = jax.lax.scan(body, (sums, counts), starts)
            return sums, counts

        sums = jnp.zeros((C + 1, d), jnp.float32)
        counts = jnp.zeros((C + 1,), jnp.float32)
        for lo in range(0, total, chunk):
            sums, counts = fold(jnp.int32(lo), sums, counts)
        self.centroids = jnp.where(
            counts[:C, None] > 0,
            sums[:C] / jnp.maximum(counts[:C, None], 1.0),
            self.centroids,
        )
    # --- search -----------------------------------------------------

    def preload(self, queries: np.ndarray, *, batch_size: int = 2048):
        nq, d = queries.shape
        nq_pad = _round_up(max(nq, 1), batch_size)
        q_all = np.zeros((nq_pad, d), np.float32)
        q_all[:nq] = queries.astype(np.float32)
        return jnp.asarray(q_all), nq

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        probes: int = 0,
        shared: int = 0,
        tile: int = 0,
        kk: int = 0,
        batch_size: int = 2048,
        preloaded=None,
        with_dists: bool = True,
        fallback: float = 0.5,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Tile-shared routed search over the clustered split tables.

        probes: per-query probe wishes (stage-1 nearest centroids);
        <= 0 = auto, the measured >=0.95 frontier by C (_auto_probes —
        32 below C~8k, deepening to 128 at the 100M-class C~26k).
        shared: per-tile granted union width P (default 3*probes/2).
        kk: scan survivors per query fed to the exact re-rank
        (default 8*k, <= cls). Coverage (granted wish fraction) lands in self.last_coverage —
        size `shared` so coverage ~1 (measured knobs:
        scripts/scale_capacity_routed.py). fallback > 0 makes recall a
        guarantee anyway: queries whose own granted-wish fraction falls
        below it re-run in narrow tiles (T=16) wide enough to grant
        EVERY wish (shared = 16*probes), the ivf.py search_routed spill
        pattern; count in self.last_fallback."""
        if probes <= 0:
            probes = _auto_probes(self.C)
        tile, shared = _auto_knobs(self.C, probes, tile, shared)
        probes = min(probes, self.C)
        if kk <= 0:
            kk = 8 * k
        kk = min(kk, self.cls)
        nq, d = queries.shape
        batch_size = max(tile, _round_up(min(batch_size, max(nq, 1)), tile))
        if preloaded is not None:
            q_dev, nq_real = preloaded
            assert nq_real == nq and q_dev.shape[0] % batch_size == 0
            nq_pad = q_dev.shape[0]
        else:
            nq_pad = _round_up(nq, batch_size)
            q_all = np.zeros((nq_pad, d), np.float32)
            q_all[:nq] = queries.astype(np.float32)
            q_dev = jnp.asarray(q_all)
        rs_key, rs_cents = (
            self.row_source if self.row_source is not None else (None, None)
        )
        parts = []
        covs = []
        for lo in range(0, nq_pad, batch_size):
            parts.append(
                routed_split_search_at(
                    self.centroids, self.comp, self.aux_r, self.gid,
                    self.base_dev, self.sqnorms, rs_key, rs_cents,
                    q_dev, lo,
                    k=k, p=probes, P=shared, T=tile, kk=kk,
                    metric=self.metric, C=self.C, cap=self.cap,
                    cls=self.cls, batch=batch_size,
                )
            )
            covs.append(parts[-1][2])
        all_i = jnp.concatenate([p[1] for p in parts], axis=0)
        all_d = jnp.concatenate([p[0] for p in parts], axis=0)
        out_i = np.asarray(all_i)[:nq]
        out_d = np.asarray(all_d)[:nq] if with_dists else np.zeros(
            (nq, k), np.float32
        )
        self.last_coverage = float(np.mean([np.asarray(c) for c in covs]))
        self.last_fallback = 0
        if fallback > 0:
            g_all = np.concatenate(
                [np.asarray(p[3]) for p in parts]
            )[:nq]
            need = np.where(g_all < fallback)[0]
            self.last_fallback = int(len(need))
            if len(need):
                # narrow-tile spill (_spill_plan): the spilled queries'
                # recall floor is the plain per-query probe recall
                out_i = out_i.copy()
                out_d = out_d.copy()
                Ts, Ps, bucket = _spill_plan(len(need), probes, self.C)
                qs = np.zeros((bucket, d), np.float32)
                qs[: len(need)] = np.asarray(queries)[need].astype(
                    np.float32
                )
                fb = routed_split_search_at(
                    self.centroids, self.comp, self.aux_r, self.gid,
                    self.base_dev, self.sqnorms, rs_key, rs_cents,
                    jnp.asarray(qs), 0,
                    k=k, p=probes, P=Ps, T=Ts, kk=kk,
                    metric=self.metric, C=self.C, cap=self.cap,
                    cls=self.cls, batch=bucket,
                )
                out_i[need] = np.asarray(fb[1])[: len(need)]
                if with_dists:
                    out_d[need] = np.asarray(fb[0])[: len(need)]
        return out_i, out_d

    def cost_counters(self, nq: int, k: int = 10, *, probes: int = 0,
                      shared: int = 0, tile: int = 0) -> dict:
        """Analytic per-run cost (statistics.hh:122-141 analogue);
        probes/tile/shared <= 0 resolve with the same auto rules as
        search."""
        if probes <= 0:
            probes = _auto_probes(self.C)
        tile, shared = _auto_knobs(self.C, probes, tile, shared)
        groups = -(-nq // tile)
        row_bytes = self.comp.shape[1] * self.comp.dtype.itemsize + 12
        return {
            "distance_computations": nq * (self.C + shared * self.cap
                                           + 8 * k),
            "scanned_rows": nq * shared * self.cap,
            "hbm_gather_bytes": groups * shared * self.cap * row_bytes,
            "ici_exchange_bytes": 0,
        }


def _auto_probes(C: int) -> int:
    """Measured >=0.95 probe frontier by coarse-cluster count (the
    nearest-assignment ceiling deepens with C — the routing-coverage
    study and the 100M deep-probe sweep):
    C~1.1k (4.19M rows) p=32 -> 0.9954; C~10.7k (41.9M) p=48 -> 0.9693
    (p=32 sits at the 0.95 edge); C~25.8k (100.66M) p=96 -> 0.9584,
    p=128 -> 0.9621. 16*ceil(C/4096) clamped to [32, 128] passes
    through all three."""
    return min(128, max(32, 16 * -(-C // 4096)))


def _auto_knobs(C: int, probes: int, tile: int, shared: int):
    """The measured (tile, shared) auto rule, shared by every routed
    split search/cost_counters site (single-chip + SPMD): the
    routing-coverage study shows big-C grants need narrow tiles
    and ~12x-probes width; small-C (<= ~4k) shares fine at T=64 / 6x.
    Over-grant is linear scan cost; under-grant is covered by the
    fallback spill either way. tile/shared <= 0 = auto."""
    if tile <= 0:
        tile = 32 if C >= 4096 else 64
    if shared <= 0:
        shared = (12 if C >= 4096 else 6) * probes
    # a tile of T queries x p wishes can never want more than T*p
    # distinct clusters — granting past that is pure wasted scan (the
    # full-grant bound; at 0.8B-class C the tile overlap vanishes and
    # this bound IS the coverage-1 setting)
    return tile, min(shared, tile * probes, C)


def _spill_plan(n_need: int, probes: int, C: int):
    """Shared spill policy (single-chip search + the SPMD path in
    parallel/routed_sharded.py — keep them identical): narrow T=16
    tiles with shared = T*probes grant EVERY wish by construction;
    the power-of-two query bucket (min 64) bounds compiled shapes."""
    Ts = 16
    Ps = min(C, Ts * probes)
    bucket = 1 << max(int(np.ceil(np.log2(max(n_need, 1)))), 6)
    return Ts, Ps, bucket


def scan_select(comp, aux_r, gid, q_s, cols, *, C: int, T: int, cap: int,
                cls: int, kk: int):
    """Routed class-max scan + per-query survivor extraction: returns
    cand (B, kk) GLOBAL row ids (-1 invalid), affinity-sorted query
    order. Shared by the single-chip dispatch and the cluster-sharded
    SPMD path (parallel/routed_sharded.py) — `gid` carries global ids,
    so the caller's table layout (whole or per-shard slice) is opaque.
    C is the caller's cluster count for THIS table (C_loc on a shard);
    comp may carry ingest-pad rows past (C+1)*cap. Invalid columns
    point at the PAD cluster (id C, nrm = NEG), whose rows never win."""
    B, dq = q_s.shape
    G, P = cols.shape
    members = cap // cls
    dpc = comp.shape[1]
    comp3 = comp[: (C + 1) * cap].reshape(C + 1, cap, dpc)
    qpad = jnp.zeros((G, T, dpc), jnp.float32)
    qpad = qpad.at[:, :, :dq].set(q_s.reshape(G, T, -1))
    blk = comp3[cols].astype(jnp.bfloat16)  # (G, P, cap, dpc)
    aux_b = aux_r[cols]  # (G, P, 2*members, cls)
    dots = jnp.einsum(
        "gtd,gcd->gtc",
        qpad.astype(jnp.bfloat16),
        blk.reshape(G, P * cap, dpc),
        preferred_element_type=jnp.float32,
    ).reshape(G, T, P, members, cls)
    nrm_b = aux_b[:, :, :members].reshape(G, 1, P, members, cls)
    scl_b = aux_b[:, :, members:].reshape(G, 1, P, members, cls)
    sc = (dots * scl_b + nrm_b).reshape(G, T, P * members, cls)
    best = jnp.max(sc, axis=2).reshape(B, cls)
    code = jnp.argmax(sc, axis=2).astype(jnp.int32)  # first max wins
    lane = jnp.arange(cls, dtype=jnp.int32)
    code = (code * cls + lane[None, None, :]).reshape(B, cls)

    # per-query top-kk survivors from the class lanes -> global ids
    bestk, sel = jax.lax.top_k(best, kk)  # scores maximize
    lrow = jnp.take_along_axis(code, sel, axis=1)  # (B, kk) local rows
    g_of_q = jnp.arange(B, dtype=jnp.int32) // T
    trow = cols[g_of_q[:, None], lrow // cap] * cap + lrow % cap
    return jnp.where(bestk > NEG / 2, gid[trow], -1)


@partial(
    jax.jit,
    static_argnames=(
        "k", "p", "P", "T", "kk", "metric", "C", "cap", "cls", "batch",
    ),
)
def routed_split_search_at(
    cents, comp, aux_r, gid, base_dev, sqnorms, rs_key, rs_cents, q_dev, lo,
    *, k, p, P, T, kk, metric, C, cap, cls, batch,
):
    """One fused routed dispatch on the clustered split tables: stage-1
    probe selection, on-device affinity sort, sort-based rank-major tile
    unions, the routed class-max block scan, exact re-rank."""
    from shine_tpu.ops.distance import (
        pairwise_distance,
        regen_rerank_topk,
        rerank_topk,
    )

    B = batch
    G = B // T
    q = jax.lax.dynamic_slice(q_dev, (lo, 0), (B, q_dev.shape[1]))
    q = q.astype(jnp.float32)

    # stage 1: per-query probe wishes
    scores1 = pairwise_distance(q, cents, metric)  # (B, C)
    if C >= 4096 and p < C:
        _, probes_ = jax.lax.approx_max_k(-scores1, p, recall_target=0.999)
    else:
        _, probes_ = jax.lax.top_k(-scores1, p)

    # affinity sort by (top1, top2) probe — spatially-ordered cluster ids
    # make tile neighbors share unions (ivf.py:_spatial_order_centroids)
    if p > 1:
        perm = jnp.argsort(probes_[:, 1], stable=True)
        perm = perm[jnp.argsort(probes_[perm, 0], stable=True)]
    else:
        perm = jnp.argsort(probes_[:, 0], stable=True)
    inv = jnp.argsort(perm, stable=True)
    q_s = q[perm]
    cols, coverage, q_granted = _route_cols(
        probes_[perm].reshape(G, T, p), C, P
    )
    cand = scan_select(
        comp, aux_r, gid, q_s, cols, C=C, T=T, cap=cap, cls=cls, kk=kk,
    )

    if rs_key is not None:
        d_out, i_out = regen_rerank_topk(
            rs_key, rs_cents, q_s, cand, k, metric
        )
    else:
        d_out, i_out = rerank_topk(
            base_dev.astype(jnp.float32), sqnorms, q_s, cand, k, metric
        )
    return d_out[inv], i_out[inv], coverage, q_granted[inv]


# --- builder --------------------------------------------------------


def fold_gt_stream(rowfn, n: int, queries: np.ndarray, metric: int,
                   *, gt_k: int = 10, rchunk: int = 131_072) -> np.ndarray:
    """Exact f32 ground truth by streaming row chunks through `rowfn`
    (natural id order) — resident footprint is one chunk plus the
    (nq, gt_k) heads. Run BEFORE the clustered ingest: folding GT into
    the ingest scan made its transients coexist with the packed tables
    and was the ResourceExhausted margin at 100M (r3c stage B)."""
    rchunk = min(rchunk, max(n, 1))
    q_dev = jnp.asarray(np.ascontiguousarray(queries, np.float32))
    qn = jnp.sum(q_dev * q_dev, axis=1)
    steps = -(-n // rchunk)

    @jax.jit
    def run(q_arg, qn_arg):
        def body(carry, c):
            gt_d, gt_i = carry
            ids = c * rchunk + jnp.arange(rchunk, dtype=jnp.int32)
            valid = ids < n
            x = rowfn(jnp.minimum(ids, n - 1))
            dots = jax.lax.dot_general(
                q_arg, x, (((1,), (1,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )
            dd = (
                qn_arg[:, None] - 2.0 * dots + jnp.sum(x * x, 1)[None, :]
                if metric == METRIC_L2 else 1.0 - dots
            )
            dd = jnp.where(valid[None, :], dd, jnp.inf)
            all_d = jnp.concatenate([gt_d, dd], axis=1)
            all_i = jnp.concatenate(
                [gt_i, jnp.broadcast_to(ids[None, :], dd.shape)], axis=1
            )
            nd, sel = jax.lax.top_k(-all_d, gt_k)
            return (-nd, jnp.take_along_axis(all_i, sel, axis=1)), None

        gt0 = (
            jnp.full((q_arg.shape[0], gt_k), jnp.inf, jnp.float32),
            jnp.full((q_arg.shape[0], gt_k), -1, jnp.int32),
        )
        (gt_d, gt_i), _ = jax.lax.scan(
            body, gt0, jnp.arange(steps, dtype=jnp.int32)
        )
        return gt_i

    return np.asarray(run(q_dev, qn))


def _plan_routed(n, dim, *, rowfn, cap_target, cls, cap_slack, shards,
                 train_size, kmeans_iters, seed, achunk, say, assign_r=8):
    """Stages A-C of the routed build (train / stream assignment
    choices / capacity-bounded cluster-major order). Shared by the
    single-chip builder and the direct per-shard SPMD build
    (parallel/routed_sharded.py:build_routed_split_sharded); all three
    stages are deterministic functions of (n, knobs, seed), so every
    caller lands on the same cluster-major id order.

    assign_r: per-row nearest-centroid choices offered to the capacity
    assignment. The measured failure mode of R=2 at 41.9M (C=10752,
    slack 1.05): 31% of ground-truth rows overflowed both choices and
    fell to the round-robin open-slot fallback — i.e. into effectively
    RANDOM clusters (median centroid rank ~5k of 10752), capping
    routed recall at 0.82 no matter how many clusters are probed.
    With R choices a spilled row
    still lands within its R nearest clusters — reachable by any
    p >= R probe setting.

    Returns (cents_dev (C, d) f32, order ((C+1)*cap,) i32 host with
    -1 = empty slot and cluster C = PAD, C, cap, rchunk)."""
    from shine_tpu.models.ivf import (
        _capacity_assign_host,
        _lloyd_balance_refine,
        _lloyd_chunked,
        _nearest_r_chunk,
        _spatial_order_centroids,
    )

    cap = _round_up(max(cap_target, 4 * cls), 4 * cls)
    # C % shards == 0 (round-robin cluster ownership,
    # parallel/routed_sharded.py); the ingest sweep (rchunk = m*cap
    # rows/step) pads its row count up to a multiple of rchunk
    # independently, so C is free of the ingest tiling
    m_ing = max(1, min(65_536 // cap, 64))
    C = _round_up(max(2, shards, math.ceil(cap_slack * n / cap)), shards)
    rchunk = m_ing * cap

    # A: train — auto-raise the sample with C. Measured on the chip
    # (r3e queue): the 4.19M build trained at ~122 rows/cluster and
    # placed 79% of rows in their top-2 choices; a 24/cluster floor at
    # 41.9M (C=10752) placed only 56% — per-cell mass estimated from
    # ~24 samples has ~20% relative error, exactly the overflow margin.
    # 96 rows/cluster, capped at 2M rows / n.
    ts = min(max(train_size, min(96 * C, 2_097_152)), n)
    lchunk = min(8192, ts)
    ts -= ts % lchunk
    kt = jax.random.PRNGKey(seed)
    train_ids = jax.random.randint(kt, (ts,), 0, n, dtype=jnp.int32)
    x_train = jax.jit(rowfn)(train_ids)
    cents = _lloyd_chunked(
        x_train, k=C, iters=kmeans_iters, seed=seed, chunk=lchunk
    )
    # capacity-aware refinement: without it, Lloyd cells in dense
    # regions hold >> cap rows and ingest cascades their overflow to
    # far clusters no probe list reaches (the 41.9M 0.82 routing
    # ceiling)
    cents = _lloyd_balance_refine(
        x_train, cents, k=C, rounds=3, R=assign_r, chunk=lchunk
    )
    cents = np.asarray(cents)
    cents = cents[_spatial_order_centroids(cents, seed)]
    cents_dev = jnp.asarray(cents)
    say(f"# routed_split: trained C={C} cap={cap} on {ts} rows")

    # B: stream assignment choices
    while n % achunk or achunk > n:
        achunk //= 2
    from shine_tpu.ops.distance import squared_norms

    csq = squared_norms(cents_dev)  # ranks centroids: HIGHEST precision

    R = max(2, min(assign_r, C))
    # sub-chunk INSIDE the jit: the (achunk, C) distance tile is 27 GB
    # at achunk=262144 x C=25805 and XLA sometimes materializes it
    # whole (the r3e 100M OOM); a scan over (sub, C) tiles bounds the
    # temp at <=0.85 GB by construction, one dispatch per achunk rows
    sub = min(8192, achunk)

    @jax.jit
    def assign_chunk(lo):
        ids = lo + jnp.arange(achunk, dtype=jnp.int32)

        def body(_, s):
            return _, _nearest_r_chunk(rowfn(s), cents_dev, csq, R=R)

        _, (ii, dd) = jax.lax.scan(body, None, ids.reshape(-1, sub))
        return ii.reshape(achunk, R), dd.reshape(achunk, R)

    choice = np.empty((n, R), np.int32)
    choice_d = np.empty((n, R), np.float32)
    for lo in range(0, n, achunk):
        c2, d2 = assign_chunk(jnp.int32(lo))
        choice[lo:lo + achunk] = np.asarray(c2)
        choice_d[lo:lo + achunk] = np.asarray(d2)
    say(f"# routed_split: assignment choices streamed ({n} rows, R={R})")

    # C: capacity assignment + cluster-major order (+ pad cluster).
    # Residue rows (all R choices full) are re-chosen among clusters
    # that still have ROOM — a device-masked nearest-open pass — so
    # even cascading dense-region overflow stays near-nearest instead
    # of round-robin-random (the measured 41.9M recall ceiling).
    assign = _capacity_assign_host(choice, choice_d, C, cap,
                                   defer_residue=True)
    un = np.where(assign < 0)[0]
    widened = len(un)
    R2 = int(min(64, C))
    wchunk = 8_192  # (wchunk, C) f32 tile stays under ~0.85 GB at 100M-C

    @jax.jit
    def widen_chunk(ids, penalty):
        xf = rowfn(ids).astype(jnp.float32)
        dots = jax.lax.dot_general(
            xf, cents_dev, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        dd = (jnp.sum(xf * xf, -1, keepdims=True) - 2.0 * dots
              + csq[None, :] + penalty[None, :])
        # approx above 4k clusters (the _nearest_r_chunk rule): widen
        # choices re-sort by true distance at admission, so a rank
        # near-miss only nudges the spill order
        if C >= 4096 and R2 < C:
            nd, ii = jax.lax.approx_max_k(-dd, R2, recall_target=0.99)
        else:
            nd, ii = jax.lax.top_k(-dd, R2)
        return ii.astype(jnp.int32), -nd

    # iterate: open clusters near dense regions fill during a widen
    # round, so the residue re-chooses against the REMAINING room (one
    # round left 5.3% of 41.9M round-robin-random, r3e measurement)
    for _ in range(4):
        if not len(un):
            break
        room = cap - np.bincount(
            np.maximum(assign, 0), weights=(assign >= 0), minlength=C
        )[:C].astype(np.int64)
        penalty = jnp.asarray(
            np.where(room > 0, 0.0, np.inf), jnp.float32
        )
        # pad to whole chunks: one compiled widen shape for all rounds
        un_pad = np.zeros(_round_up(len(un), wchunk), np.int32)
        un_pad[:len(un)] = un
        cho2 = np.empty((len(un_pad), R2), np.int32)
        cho2_d = np.empty((len(un_pad), R2), np.float32)
        for lo in range(0, len(un_pad), wchunk):
            ii, dd2 = widen_chunk(
                jnp.asarray(un_pad[lo:lo + wchunk]), penalty
            )
            cho2[lo:lo + wchunk] = np.asarray(ii)
            cho2_d[lo:lo + wchunk] = np.asarray(dd2)
        assign2 = _capacity_assign_host(
            cho2[:len(un)], cho2_d[:len(un)], C, room, defer_residue=True
        )
        assign[un] = assign2
        un = un[assign2 < 0]
    if len(un):
        # truly nothing open near them: round-robin the open slots
        room = cap - np.bincount(
            np.maximum(assign, 0), weights=(assign >= 0), minlength=C
        )[:C].astype(np.int64)
        open_slots = np.repeat(np.arange(C), np.maximum(room, 0))
        assign[un] = open_slots[: len(un)]
    assert (assign >= 0).all()
    ranks = np.full(n, R, np.int16)
    for r in range(R - 1, -1, -1):
        ranks[assign == choice[:, r]] = r
    hist = np.bincount(ranks, minlength=R + 1).astype(np.float64) / n
    say(f"# routed_split: assign ranks r0={hist[0]:.4f} r1={hist[1]:.4f} "
        f"r2+={hist[2:R].sum():.4f} widened={widened / n:.6f} "
        f"rr={len(un) / n:.6f}")
    sort_idx = np.argsort(assign, kind="stable")
    sa = assign[sort_idx]
    first = np.searchsorted(sa, np.arange(C))
    slot = np.arange(n, dtype=np.int64) - first[sa]
    order = np.full((C + 1) * cap, -1, np.int32)
    order[sa * cap + slot] = sort_idx.astype(np.int32)
    say(f"# routed_split: capacity assign done (cap={cap}, "
        f"fill={n / (C * cap):.3f})")

    return cents_dev, order, C, cap, rchunk


def build_routed_split(
    n: int,
    dim: int,
    *,
    row_source=None,
    base_dev=None,
    metric: str | int = "l2",
    cap_target: int = 4096,
    cls: int = 1024,
    cap_slack: float = 1.05,
    shards: int = 1,
    comp_dtype: str = "int8",
    train_size: int = 131_072,
    kmeans_iters: int = 20,
    seed: int = 1234,
    achunk: int = 262_144,
    assign_r: int = 8,
    queries: np.ndarray | None = None,
    gt_k: int = 10,
    log=None,
):
    """Build the clustered split tables WITHOUT a resident f32 base.

    The cluster capacity is the DMA/select block: cap = cap_target
    rounded to a multiple of 4*cls (whole class rows per cluster block),
    and C = ~slack*n/cap clusters follow.
    One extra PAD cluster (id C, nrm=NEG, gid=-1) absorbs ungranted
    column slots so the kernel needs no mask. Stages (each streams over
    regenerated row chunks):
      A. train balanced-k-means centroids on a sampled subset
         (_lloyd_chunked) + spatial cluster ordering;
      B. stream top-2 nearest-centroid choices to the host;
      C. capacity-bounded nearest-first assignment over `assign_r`
         choices (ivf.py:_capacity_assign_host; R=8 default — see
         _plan_routed on why R=2 randomized 31% of dense-region rows)
         -> cluster-major id order;
      D. stream the PERMUTED id order through the split packer
         (pack_split_device). Exact f32 ground truth for `queries` is
         folded in a SEPARATE pre-ingest pass (fold_gt_stream) so its
         transients never share device memory with the packed tables.

    Returns RoutedSplitIndex, or (RoutedSplitIndex, gt) when `queries`
    is given."""
    from shine_tpu.ops.packing import (
        aux_routed_layout_chunk,
        comp_width,
        pack_split_device,
    )

    metric = metric_id(metric)
    say = log if log is not None else (lambda *_: None)
    rowfn = _make_rowfn(row_source, base_dev, metric)
    dpc = comp_width(dim)
    int8 = comp_dtype == "int8"

    cents_dev, order, C, cap, rchunk = _plan_routed(
        n, dim, rowfn=rowfn, cap_target=cap_target, cls=cls,
        cap_slack=cap_slack, shards=shards, train_size=train_size,
        kmeans_iters=kmeans_iters, seed=seed, achunk=achunk, say=say,
        assign_r=assign_r,
    )

    # exact GT BEFORE the big tables exist (fold_gt_stream docstring)
    gt_i = None
    if queries is not None:
        gt_i = fold_gt_stream(rowfn, n, queries, metric, gt_k=gt_k)
        say("# routed_split: exact ground truth folded (pre-ingest)")

    # D: clustered ingest; the sweep runs over n_ing >= n_pad rows
    # (-1 tail pad) so rchunk never has to divide the table size. The
    # comp table KEEPS its n_ing padded length: slicing to n_pad would
    # materialize a second copy of the largest HBM array (the scan's
    # stacked output cannot alias a differently-sized slice), which was
    # the other half of the 100M ResourceExhausted. One padded order
    # array serves both the ingest sweep and the index's gid.
    n_pad = (C + 1) * cap
    n_ing = _round_up(n_pad, rchunk)
    if n_ing != n_pad:
        order_ing = np.full(n_ing, -1, np.int32)
        order_ing[:n_pad] = order
        order_dev = jax.device_put(order_ing)
    else:
        order_dev = jax.device_put(order)

    @jax.jit
    def ingest(order_arg):
        def body(_, c):
            gids = jax.lax.dynamic_slice(order_arg, (c * rchunk,), (rchunk,))
            valid = gids >= 0
            x = rowfn(jnp.maximum(gids, 0))
            x = jnp.where(valid[:, None], x, 0.0)
            comp_c, aux_c = pack_split_device(
                x, metric=metric, dpc=dpc, int8=int8, rchunk=rchunk
            )
            aux_c = aux_c.at[0].set(jnp.where(valid, aux_c[0], NEG))
            # cluster-block layout per chunk (rchunk % cap == 0 by
            # _plan_routed) so the flat (2, n_pad) aux + its transpose
            # never coexist with the comp table — the 100M OOM fix
            aux_b = aux_routed_layout_chunk(aux_c, cap, cls)
            return _, (comp_c, aux_b)

        _, (comp_s, aux_s) = jax.lax.scan(
            body, None, jnp.arange(n_ing // rchunk, dtype=jnp.int32)
        )
        members = cap // cls
        aux_r = aux_s.reshape(n_ing // cap, 2 * members, cls)[: C + 1]
        return comp_s.reshape(n_ing, dpc), aux_r

    comp, aux_r = ingest(order_dev)
    say("# routed_split: clustered tables packed")

    idx = RoutedSplitIndex(
        cents_dev, comp, aux_r, order_dev, n, dim, metric, cls=cls,
        cap=cap, row_source=row_source, base_dev=base_dev,
        sqnorms=(
            jnp.sum(base_dev.astype(jnp.float32) ** 2, axis=1)
            if (base_dev is not None and metric == METRIC_L2)
            else (
                jnp.zeros(n, jnp.float32) if base_dev is not None else None
            )
        ),
    )
    if queries is not None:
        return idx, gt_i
    return idx
