"""IVF (inverted-file) index: clustered pruning with matmuls.

The accelerator-idiomatic approximate index for bases too large for brute force
(models/flat.py). Where the reference prunes with graph traversal — a
latency-bound pointer chase per visited vertex (hnsw.hh:406-476) — IVF
prunes with *geometry*: vectors are partitioned into balanced clusters
(parallel/placement.py k-means, the same machinery the reference uses for
query routing, placement.hh/kmeans.hh); a query scores all centroids with
one matmul and then scans only the top-p clusters densely.

Fixed-shape design:
  * clusters are stored as a padded dense (C, cap, d) bf16 tensor
    (cluster-major rows; -1-id padding; cap targets ~128 rows) so a probed
    cluster is one coarse contiguous 32-64 KB gather — no per-row
    scatter/gather;
  * probing is fully per-query: stage 1 scores all centroids with one
    (B, C) matmul tile and takes each query's top-p; stage 2 gathers the
    (B, p, cap, d) probe blocks, computes one (B, p*cap) bf16 distance
    einsum, top-ks, and exactly re-ranks the survivors in f32. One jit,
    no host round-trips. (An earlier tile-shared-probe design lost 30+
    recall points on heterogeneous batches — per-query probe sets are
    cheap at small caps because the gather stays block-granular.)

Recall is tuned by p (probes) like ef in HNSW.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from shine_tpu.config import METRIC_L2, metric_id
from shine_tpu.ops.distance import pairwise_distance, rerank_topk, squared_norms


class IVFData(NamedTuple):
    centroids: jnp.ndarray  # (C, d) f32
    blocks: jnp.ndarray  # (C, cap, d) bf16
    block_sq: jnp.ndarray  # (C, cap) f32 (inf pad)
    block_ids: jnp.ndarray  # (C, cap) i32 (-1 pad)
    vectors: jnp.ndarray  # (n, d) f32 — id-ordered, for exact re-rank
    sqnorms: jnp.ndarray  # (n,) f32

    @property
    def num_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.blocks.shape[1]


def _capacity_assign_host(
    choice: np.ndarray,  # (n, R) i32 — per-row nearest clusters, best first
    choice_d: np.ndarray,  # (n, R) f32
    num_clusters: int,
    cap,  # int, or (num_clusters,) per-cluster room
    v32: np.ndarray | None = None,  # only for the rare overflow fallback
    cents: np.ndarray | None = None,
    *,
    defer_residue: bool = False,
) -> np.ndarray:
    """Nearest-first capacity-bounded assignment (host, vectorized).

    Points take their rank-r choice in (distance, cluster)-sorted order
    while the cluster has room; overflow spills to rank r+1. The rare
    residue (no top-R choice had room) goes to the nearest open cluster.
    This is the capacity_assign scheme of parallel/placement.py shared by
    the host and device IVF builders.

    defer_residue=True returns the residue UNASSIGNED (-1) instead of
    falling back — the routed builder re-chooses those rows among OPEN
    clusters on device (models/routed_split.py:_plan_routed), which
    keeps capacity spill probe-reachable instead of round-robin-random.
    """
    n, R = choice.shape
    assign = np.full(n, -1, dtype=np.int64)
    if np.ndim(cap) == 0:
        room = np.full(num_clusters, cap, dtype=np.int64)
    else:
        room = np.asarray(cap, dtype=np.int64).copy()
    for r in range(R):
        un = np.where(assign < 0)[0]
        if len(un) == 0:
            break
        c_r = choice[un, r]
        order = np.lexsort((choice_d[un, r], c_r))
        un, c_r = un[order], c_r[order]
        # rank within cluster group
        first = np.concatenate([[True], c_r[1:] != c_r[:-1]])
        group_start = np.maximum.accumulate(np.where(first, np.arange(len(c_r)), 0))
        rank = np.arange(len(c_r)) - group_start
        ok = rank < room[c_r]
        assign[un[ok]] = c_r[ok]
        np.subtract.at(room, c_r[ok], 1)
    if defer_residue:
        return assign
    # final fallback: any cluster with room, nearest-first by centroid dist
    un = np.where(assign < 0)[0]
    if len(un):
        if v32 is not None and cents is not None and len(un) <= 65536:
            open_cs = np.where(room > 0)[0]
            dtile = np.asarray(
                pairwise_distance(jnp.asarray(v32[un]), jnp.asarray(cents[open_cs]))
            )
            pref = np.argsort(dtile, axis=1, kind="stable")
            for i, qi in enumerate(un):
                for c in open_cs[pref[i]]:
                    if room[c] > 0:
                        assign[qi] = c
                        room[c] -= 1
                        break
        else:
            # no vectors at hand (device builder): round-robin the open slots
            open_slots = np.repeat(
                np.arange(num_clusters), np.maximum(room, 0)
            )
            assign[un] = open_slots[: len(un)]
    assert (assign >= 0).all()
    return assign


def _spatial_order_centroids(cents: np.ndarray, seed: int) -> np.ndarray:
    """Permutation that relabels clusters so spatially-near centroids get
    adjacent ids. Without this, routed tile unions collapse: sorting
    queries by probe id mixes unrelated regions in one tile (measured on
    chip: probe coverage 0.13 with arbitrary ids at C=1563). Coarse
    k-means over the centroids themselves defines the macro order;
    within a macro group, order by distance to the group mean."""
    C = cents.shape[0]
    k = max(1, min(C // 8, 256))
    if k <= 1:
        return np.arange(C)
    from shine_tpu.parallel.placement import _lloyd

    coarse, _ = _lloyd(jnp.asarray(cents), k=k, iters=15, seed=seed)
    coarse = np.asarray(coarse)
    d2 = np.asarray(
        pairwise_distance(jnp.asarray(cents), jnp.asarray(coarse))
    )
    g = d2.argmin(axis=1)
    return np.lexsort((d2[np.arange(C), g], g))


def build_ivf_layout(
    vectors: np.ndarray,
    num_clusters: int,
    *,
    metric: int = METRIC_L2,
    train_size: int = 100_000,
    iters: int = 25,
    seed: int = 1234,
    cap_slack: float = 1.25,
) -> IVFData:
    """Balanced clustering + cluster-major dense layout.

    Points are assigned nearest-first with per-cluster capacity
    cap = ceil(slack * n / C); overflow spills to the next-nearest cluster
    with room (the capacity_assign scheme of parallel/placement.py, applied
    chunked so the (n, C) distance tile never fully materializes).
    """
    from shine_tpu.parallel.placement import _lloyd

    n, d = vectors.shape
    v32 = np.ascontiguousarray(vectors, dtype=np.float32)
    rng = np.random.default_rng(seed)
    train = v32[rng.choice(n, min(train_size, n), replace=False)]
    cents, _ = _lloyd(jnp.asarray(train), k=num_clusters, iters=iters, seed=seed)
    cents = np.asarray(cents)
    cents = cents[_spatial_order_centroids(cents, seed)]

    cap = int(np.ceil(cap_slack * n / num_clusters))
    # chunked nearest-centroid ranking (keep top 4 choices per point)
    # 8 assignment choices: R=2-4 let capacity overflow fall through to
    # far clusters (the measured routed-split spill); more choices keep
    # spilled rows probe-reachable
    R = min(8, num_clusters)
    choice = np.empty((n, R), dtype=np.int32)
    choice_d = np.empty((n, R), dtype=np.float32)
    for lo in range(0, n, 65536):
        hi = min(lo + 65536, n)
        dtile = np.asarray(
            pairwise_distance(jnp.asarray(v32[lo:hi]), jnp.asarray(cents))
        )
        part = np.argpartition(dtile, R - 1, axis=1)[:, :R]
        pd = np.take_along_axis(dtile, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        choice[lo:hi] = np.take_along_axis(part, order, axis=1)
        choice_d[lo:hi] = np.take_along_axis(pd, order, axis=1)

    assign = _capacity_assign_host(choice, choice_d, num_clusters, cap, v32, cents)

    blocks = np.zeros((num_clusters, cap, d), dtype=np.float32)
    block_sq = np.full((num_clusters, cap), np.inf, dtype=np.float32)
    block_ids = np.full((num_clusters, cap), -1, dtype=np.int32)
    # vectorized cluster-major fill: slot = rank within the cluster group
    # (a per-row Python loop here is minutes at 1M rows)
    order = np.argsort(assign, kind="stable")
    sa = assign[order]
    first = np.searchsorted(sa, np.arange(num_clusters))
    slot = np.arange(n, dtype=np.int64) - first[sa]
    blocks[sa, slot] = v32[order]
    block_ids[sa, slot] = order.astype(np.int32)
    sq = (blocks * blocks).sum(-1)
    block_sq = np.where(block_ids >= 0, sq, np.inf)
    if metric != METRIC_L2:
        block_sq = np.where(block_ids >= 0, 0.0, np.inf).astype(np.float32)
    sqn = (v32 * v32).sum(-1) if metric == METRIC_L2 else np.zeros(n, np.float32)
    return IVFData(
        centroids=jnp.asarray(cents),
        blocks=jnp.asarray(blocks, dtype=jnp.bfloat16),
        block_sq=jnp.asarray(block_sq),
        block_ids=jnp.asarray(block_ids),
        vectors=jnp.asarray(v32),
        sqnorms=jnp.asarray(sqn.astype(np.float32)),
    )


@partial(jax.jit, static_argnames=("k", "iters", "chunk"))
def _lloyd_chunked(points: jnp.ndarray, *, k: int, iters: int, seed: int,
                   chunk: int = 8192):
    """Lloyd iterations that never materialize the (n, k) distance tile —
    required when k is tens of thousands (the 10M-row IVF build). Each
    chunk's (chunk, k) scores live only inside one scan step; centroid
    sums accumulate via scatter-add. Random-row init (k-means++ is
    O(n*k) per pick — pointless at this k)."""
    n, d = points.shape
    key = jax.random.PRNGKey(seed)
    idx = jax.random.choice(key, n, (k,), replace=False)
    cents0 = points[idx].astype(jnp.float32)
    xs = points.reshape(n // chunk, chunk, d).astype(jnp.float32)

    def iter_body(_, cents):
        csq = squared_norms(cents)

        def scan_body(carry, x):
            sums, counts = carry
            dots = jax.lax.dot_general(
                x, cents, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            a = jnp.argmin(csq[None, :] - 2.0 * dots, axis=1)
            return (sums.at[a].add(x), counts.at[a].add(1.0)), None

        (sums, counts), _ = jax.lax.scan(
            scan_body, (jnp.zeros((k, d)), jnp.zeros((k,))), xs
        )
        return jnp.where(counts[:, None] > 0.5,
                         sums / jnp.maximum(counts[:, None], 1.0), cents)

    return jax.lax.fori_loop(0, iters, iter_body, cents0)


def _lloyd_balance_refine(points: jnp.ndarray, cents: jnp.ndarray, *,
                          k: int, rounds: int = 3, R: int = 8,
                          chunk: int = 8192):
    """Capacity-aware refinement of Lloyd centroids at chunked scale —
    the placement.py kmeans(balanced=True) / reference penalty-based
    balanced k-means (kmeans.hh:259-377) recipe, usable at k in the
    tens of thousands. Each round capacity-assigns the training sample
    (per-cluster cap = ceil(n/k), nearest-first over top-R choices) and
    recomputes centroids from THAT assignment, so cells that would
    overflow their share migrate centroids INTO dense regions instead
    of letting ingest spill rows to far clusters. Deterministic."""
    n, d = points.shape
    cap_t = -(-n // k)
    xs = points.astype(jnp.float32)
    Rr = min(R, k)

    # xs passed as an argument, never captured (a captured device array
    # becomes a compile-time constant; a large one stalls the compile)
    @jax.jit
    def choices(xs_arg, cents_dev):
        csq = squared_norms(cents_dev)

        def body(_, x):
            ii, dd = _nearest_r_chunk(x, cents_dev, csq, R=Rr)
            return _, (ii, dd)

        _, (ii, dd) = jax.lax.scan(
            body, None, xs_arg.reshape(n // chunk, chunk, d)
        )
        return ii.reshape(n, -1), dd.reshape(n, -1)

    @jax.jit
    def update(xs_arg, cents_dev, assign_dev):
        sums = jnp.zeros((k, d), jnp.float32).at[assign_dev].add(xs_arg)
        counts = jnp.zeros((k,), jnp.float32).at[assign_dev].add(1.0)
        return jnp.where(
            counts[:, None] > 0.5,
            sums / jnp.maximum(counts[:, None], 1.0), cents_dev
        )

    for _ in range(rounds):
        cho, cho_d = choices(xs, cents)
        assign = _capacity_assign_host(
            np.asarray(cho), np.asarray(cho_d), k, cap_t
        )
        cents = update(xs, cents, jnp.asarray(assign))
    return cents


@partial(jax.jit, static_argnames=("R",))
def _nearest_r_chunk(x: jnp.ndarray, cents: jnp.ndarray, csq: jnp.ndarray,
                     *, R: int):
    """Top-R nearest centroids for one row chunk (true L2 values — the
    host capacity sort compares distances ACROSS rows, so the per-row
    ||x||^2 term cannot be dropped). approx_max_k above 4096 clusters:
    exact top_k over a tens-of-thousands-wide axis is the measured slow
    path, and a rank-4 near-miss only nudges the capacity spill order."""
    xf = x.astype(jnp.float32)
    dots = jax.lax.dot_general(
        xf, cents, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    dd = jnp.sum(xf * xf, -1, keepdims=True) - 2.0 * dots + csq[None, :]
    if cents.shape[0] >= 4096:
        nd, idx = jax.lax.approx_max_k(-dd, R, recall_target=0.999)
    else:
        nd, idx = jax.lax.top_k(-dd, R)
    return idx.astype(jnp.int32), -nd


@partial(jax.jit, static_argnames=("cchunk",))
def _fill_blocks_device(v: jnp.ndarray, inv: jnp.ndarray, sq_v: jnp.ndarray,
                        *, cchunk: int):
    """Cluster-major fill on device: gather each cluster chunk's rows from
    the base, bf16-cast. scan stacks straight into the output buffer so
    peak memory is the final bf16 blocks + one f32 chunk."""
    C, cap = inv.shape
    xs = inv.reshape(C // cchunk, cchunk, cap)

    def body(_, ic):
        g = v[jnp.maximum(ic, 0)].astype(jnp.bfloat16)
        g = jnp.where(ic[..., None] >= 0, g, jnp.bfloat16(0))
        s = jnp.where(ic >= 0, sq_v[jnp.maximum(ic, 0)], jnp.inf)
        return None, (g, s)

    _, (blocks, bsq) = jax.lax.scan(body, None, xs)
    return (blocks.reshape(C, cap, -1), bsq.reshape(C, cap))


def build_ivf_layout_device(
    v_dev: jnp.ndarray,
    num_clusters: int,
    *,
    metric: int = METRIC_L2,
    train_size: int = 262_144,
    iters: int = 20,
    seed: int = 1234,
    cap_slack: float = 1.25,
    assign_chunk: int = 16_384,  # the (chunk, C) f32 tile must fit beside
    # the base: 16384 x 40k = 2.6 GB
    fill_chunk: int = 1024,
) -> IVFData:
    """Device-resident IVF build for bases that should not round-trip the
    host (a 10M x 128 base is 5 GB). Only the
    (n, R) nearest-centroid choices are downloaded for the capacity
    assignment; vectors never leave HBM. Mirrors build_ivf_layout
    semantics (same capacity scheme, same block layout)."""
    n, d = v_dev.shape
    key = jax.random.PRNGKey(seed)
    ts = min(train_size, n)
    lchunk = min(8192, ts)
    ts -= ts % lchunk
    if ts < num_clusters:
        raise ValueError("train_size must be >= num_clusters")
    if ts < 16 * num_clusters:
        import sys as _sys

        # measured at 10M/C=39k: ~7 training points
        # per centroid collapses recall@p32 from ~0.99 to 0.48 — the
        # centroids don't tile the data and the capacity assignment
        # scatters rows into far clusters the probes never visit
        print(
            f"# WARNING: train_size {ts} < 16*num_clusters "
            f"({16 * num_clusters}) — undertrained centroids degrade "
            "probe recall; raise train_size or lower num_clusters",
            file=_sys.stderr,
        )
    tidx = jax.random.choice(key, n, (ts,), replace=False)
    train = v_dev[tidx]
    cents = _lloyd_chunked(
        train, k=num_clusters, iters=iters, seed=seed, chunk=lchunk
    )
    cents = cents[jnp.asarray(_spatial_order_centroids(np.asarray(cents), seed))]
    csq = squared_norms(cents)

    # 8 assignment choices: R=2-4 let capacity overflow fall through to
    # far clusters (the measured routed-split spill); more choices keep
    # spilled rows probe-reachable
    R = min(8, num_clusters)
    choice = np.empty((n, R), np.int32)
    choice_d = np.empty((n, R), np.float32)
    for lo in range(0, n, assign_chunk):
        hi = min(lo + assign_chunk, n)
        x = jax.lax.dynamic_slice_in_dim(v_dev, lo, hi - lo, 0)
        ii, dd = _nearest_r_chunk(x, cents, csq, R=R)
        choice[lo:hi] = np.asarray(ii)
        choice_d[lo:hi] = np.asarray(dd)

    cap = int(np.ceil(cap_slack * n / num_clusters))
    assign = _capacity_assign_host(choice, choice_d, num_clusters, cap)
    order = np.argsort(assign, kind="stable")
    sa = assign[order]
    first = np.searchsorted(sa, np.arange(num_clusters))
    slot = np.arange(n, dtype=np.int64) - first[sa]
    inv = np.full((num_clusters, cap), -1, np.int32)
    inv[sa, slot] = order.astype(np.int32)

    C_pad = -(-num_clusters // fill_chunk) * fill_chunk
    if C_pad != num_clusters:
        inv = np.concatenate(
            [inv, np.full((C_pad - num_clusters, cap), -1, np.int32)]
        )
    inv_dev = jnp.asarray(inv)
    sq_v = jnp.sum(v_dev.astype(jnp.float32) * v_dev.astype(jnp.float32), -1)
    blocks, bsq = _fill_blocks_device(v_dev, inv_dev, sq_v, cchunk=fill_chunk)
    blocks = blocks[:num_clusters]
    bsq = bsq[:num_clusters]
    inv_dev = inv_dev[:num_clusters]
    if metric != METRIC_L2:
        bsq = jnp.where(inv_dev >= 0, 0.0, jnp.inf)
        sq_v = jnp.zeros_like(sq_v)
    return IVFData(
        centroids=cents,
        blocks=blocks,
        block_sq=bsq,
        block_ids=inv_dev,
        vectors=v_dev,
        sqnorms=sq_v,
    )


@partial(jax.jit, static_argnames=("metric",))
def ivf_stage1(data: IVFData, queries: jnp.ndarray, *, metric: int):
    """(B, C) centroid scores — one matmul tile."""
    return pairwise_distance(queries.astype(jnp.float32), data.centroids, metric)


@partial(jax.jit, static_argnames=("k", "p", "metric", "rerank", "probe_chunk",
                                   "approx_probes"))
def ivf_search(
    data: IVFData,
    queries: jnp.ndarray,  # (B, d)
    *,
    k: int,
    p: int,
    metric: int,
    rerank: int = 4,
    probe_chunk: int | None = None,
    approx_probes: bool = False,
):
    """Per-query probed search: centroid scores -> top-p probes -> dense
    bf16 scan of the probe blocks -> exact f32 re-rank of the rerank*k
    survivors. Returns (ids, dists) (B, k).

    approx_probes opts into approx_max_k probe selection above 4096
    clusters (~4x faster stage 1, measured); default is exact top_k so
    the 'p == num_clusters scans everything' invariant and the routed
    fallback's recall floor hold unconditionally. Never approximated
    when p == num_clusters."""
    q = queries.astype(jnp.float32)
    B = q.shape[0]
    d = q.shape[1]
    cap = data.cap
    scores = pairwise_distance(q, data.centroids, metric)  # (B, C)
    if approx_probes and data.num_clusters >= 4096 and p < data.num_clusters:
        _, probes = jax.lax.approx_max_k(-scores, p, recall_target=0.999)
    else:
        _, probes = jax.lax.top_k(-scores, p)  # (B, p)
    qn = jnp.sum(q * q, axis=-1)
    qb = q.astype(jnp.bfloat16)

    def probe_dists(cols):  # (B, pc) probe columns -> ((B, pc, cap) dd, ids)
        blk = data.blocks[cols]  # (B, pc, cap, d) bf16
        sqs = data.block_sq[cols]
        ids = data.block_ids[cols]
        dots = jnp.einsum(
            "bd,bpcd->bpc", qb, blk, preferred_element_type=jnp.float32
        )
        if metric == METRIC_L2:
            dd = qn[:, None, None] - 2.0 * dots + sqs
        else:
            dd = 1.0 - dots
        return jnp.where(ids >= 0, dd, jnp.inf), ids

    # the (B, p, cap, d) probe gather at full p OOMs a 16 GB chip (p=64,
    # B=4096, cap=160, d=128 is 10.7 GB bf16 before XLA's f32 upconvert);
    # stream it over probe chunks with lax.scan so peak footprint is one
    # (B, pc, cap, d) block, keeping only the (B, p, cap) f32 dists
    chunk_bytes = B * cap * d * 2
    pc = probe_chunk or max(1, min(p, (1 << 29) // max(chunk_bytes, 1)))
    if pc >= p:
        dd, ids = probe_dists(probes)
        dd = dd.reshape(B, p * cap)
        flat_ids = ids.reshape(B, p * cap)
    else:
        while p % pc:
            pc -= 1  # p is static and small; pick a divisor
        xs = jnp.moveaxis(probes.reshape(B, p // pc, pc), 1, 0)  # (p/pc, B, pc)
        _, (dd, ids) = jax.lax.scan(
            lambda _, cols: (None, probe_dists(cols)), None, xs
        )  # (p/pc, B, pc, cap)
        dd = jnp.moveaxis(dd, 0, 1).reshape(B, p * cap)
        flat_ids = jnp.moveaxis(ids, 0, 1).reshape(B, p * cap)
    kk = min(max(rerank, 1) * k, p * cap)
    nd, sel = jax.lax.top_k(-dd, kk)
    cand = jnp.take_along_axis(flat_ids, sel, axis=1)  # (B, kk)
    d_out, i_out = rerank_topk(data.vectors, data.sqnorms, q, cand, k, metric)
    return i_out, d_out


@partial(
    jax.jit,
    static_argnames=(
        "k", "p", "shared", "tile", "metric", "rerank", "approx",
        "step_budget",
    ),
)
def ivf_routed_search(
    data: IVFData,
    queries: jnp.ndarray,  # (B, d)
    *,
    k: int,
    p: int,
    shared: int,
    tile: int,
    metric: int,
    rerank: int = 4,
    approx: bool = True,
    step_budget: int = 1_000_000_000,  # HBM bytes per scan chunk; small
    # values force the tile-group streaming path (exercised in tests)
):
    """Fused routed-IVF search: ONE dispatch per batch, only result ids
    leave the device.

    Where ivf_search gathers (B, p, cap, d) per-query probe blocks — the
    measured ~31 GB/s random-gather wall — this affinity-sorts the batch
    ON DEVICE, splits it into tiles of `tile` queries, gives each tile a
    `shared`-wide probe union (rank-major priority via scatter-min), and
    gathers each union's blocks ONCE for all its queries. The per-query
    gather volume drops ~tile/(shared/p)x and the scan becomes matmul-bound.
    This is the reference's query->CN affinity routing
    (query_router.hh:353-370) reapplied on-chip. Requires spatially-
    ordered cluster ids (_spatial_order_centroids — applied by both
    builders) so the top-probe sort groups same-region queries.

    Returns (ids (B, k), dists (B, k), coverage ()) in the caller's query
    order; coverage = granted fraction of (query, rank<p) probe wishes.
    """
    B, d = queries.shape
    assert B % tile == 0, "batch must be a multiple of tile"
    G = B // tile
    T = tile
    C = data.num_clusters
    cap = data.cap
    P = min(shared, C)
    q = queries.astype(jnp.float32)

    # stage 1: per-query probes (replicated centroid tile). approx only
    # under the explicit opt-in flag (wish misses here only shift probe
    # wishes; the fallback spill path re-runs exact ivf_search)
    scores = pairwise_distance(q, data.centroids, metric)  # (B, C)
    if approx and C >= 4096 and p < C:
        _, probes = jax.lax.approx_max_k(-scores, p, recall_target=0.999)
    else:
        _, probes = jax.lax.top_k(-scores, p)

    # affinity sort: queries probing the same (spatially-ordered) clusters
    # become tile neighbors; two stable argsorts = exact (top1, top2)
    # lexsort without an overflow-prone composite key
    if p > 1:
        perm = jnp.argsort(probes[:, 1], stable=True)
        perm = perm[jnp.argsort(probes[perm, 0], stable=True)]
    else:
        perm = jnp.argsort(probes[:, 0], stable=True)
    inv = jnp.argsort(perm, stable=True)
    q_s = q[perm]
    probes_s = probes[perm].reshape(G, T, p)

    # per-tile rank-major union: scatter the flat rank-position of each
    # (query, rank) wish into a (G, C) min-position table, then the P
    # smallest positions win — every query gets its rank-r probes before
    # any query gets rank r+1 (the reference's balanced batch fairness,
    # query_router.hh:353-370)
    pos = (
        jnp.broadcast_to(
            jnp.arange(T * p, dtype=jnp.int32).reshape(p, T).T, (G, T, p)
        )
        # rank-major: position = rank * T + row
    )
    minpos = jnp.full((G, C), jnp.int32(2**30))
    minpos = minpos.at[
        jnp.arange(G)[:, None, None], probes_s
    ].min(pos)
    neg, cols = jax.lax.top_k(-minpos, P)  # (G, P) best-priority clusters
    colmask = neg > -(2**30)
    # a wish is granted iff its cluster's priority beats the worst selected
    # one (positions are unique per tile, so there are no threshold ties)
    thresh = -neg[:, -1]
    wish_pos = minpos[jnp.arange(G)[:, None, None], probes_s]
    granted = wish_pos <= thresh[:, None, None]  # (G, T, p)
    coverage = granted.mean()
    # per-query granted fraction, in caller order (drives the per-query
    # fallback for under-covered queries — cf. the reference's spill path
    # when a CN's batch budget is exhausted, query_router.hh:353-370)
    q_granted = granted.mean(axis=-1).reshape(B)[inv]

    # tile-shared scan, streamed over tile-group chunks: the gathered
    # (gc, P, cap, d) blocks + (gc, T, P, cap) scores must fit HBM
    # alongside the base (at 10M rows, cap ~6k, the unchunked form wants
    # ~13 GB of temps and OOMs a 16 GB chip). gc shrinks until the
    # per-step footprint is ~<=1 GB; the 200k case stays one step.
    qf = q_s.reshape(G, T, d)
    kk = min(max(rerank, 1) * k, P * cap)
    step_bytes = P * cap * d * 2 + T * P * cap * 4
    gc = max(1, min(G, int(step_budget // max(step_bytes, 1))))
    while G % gc:
        gc -= 1

    def scan_chunk(_, xs):
        cols_c, colmask_c, qf_c = xs  # (gc, P) (gc, P) (gc, T, d)
        blk = data.blocks[cols_c]  # (gc, P, cap, d) bf16
        sqs = data.block_sq[cols_c]
        ids_c = jnp.where(colmask_c[..., None], data.block_ids[cols_c], -1)
        dots = jnp.einsum(
            "gtd,gpcd->gtpc",
            qf_c.astype(jnp.bfloat16),
            blk,
            preferred_element_type=jnp.float32,
        )
        if metric == METRIC_L2:
            qn = jnp.sum(qf_c * qf_c, axis=-1)
            dd = qn[..., None, None] - 2.0 * dots + sqs[:, None]
        else:
            dd = 1.0 - dots
        dd = jnp.where(ids_c[:, None] >= 0, dd, jnp.inf)
        dd = dd.reshape(gc, T, P * cap)
        flat_ids = jnp.broadcast_to(
            ids_c.reshape(gc, 1, P * cap), (gc, T, P * cap)
        )
        if approx and P * cap >= 4 * kk:
            # 0.999: the probe union already prunes ~99% of rows; the
            # reduction must not give recall back (0.99 measured a
            # ~5-point drop here)
            _, sel = jax.lax.approx_max_k(-dd, kk, recall_target=0.999)
        else:
            _, sel = jax.lax.top_k(-dd, kk)
        return None, jnp.take_along_axis(flat_ids, sel, axis=-1)

    xs = (
        cols.reshape(G // gc, gc, P),
        colmask.reshape(G // gc, gc, P),
        qf.reshape(G // gc, gc, T, d),
    )
    if G // gc == 1:
        _, cand = scan_chunk(None, jax.tree.map(lambda a: a[0], xs))
        cand = cand[None]
    else:
        _, cand = jax.lax.scan(scan_chunk, None, xs)
    cand = cand.reshape(B, kk)
    d_out, i_out = rerank_topk(
        data.vectors, data.sqnorms, q_s, cand, k, metric
    )
    # undo the affinity sort
    i_out = i_out.reshape(B, k)[inv]
    d_out = d_out.reshape(B, k)[inv]
    return i_out, d_out, coverage, q_granted


def _auto_clusters(n: int, target_cap: int, layout: str) -> int:
    """Measured cluster-count rules:

    - "fine" (per-query ivf_search): cap ~ target_cap rows per cluster —
      small enough that (B, p, cap, d) probe gathers stay HBM-friendly,
      large enough for efficient dense matmul scans.
    - "routed" (tile-shared search_routed): COARSE clusters, C clamped to
      ~1-2k at any N — at 1M a fine C=7813 layout drops tile coverage to
      0.45 and recall to 0.55, while C~1.5-2k keeps coverage ~1.0 (the
      two serving modes want different layouts; pick per mode).
    """
    if layout == "routed":
        return max(8, min(2048, -(-n // 128)))
    if layout != "fine":
        raise ValueError(f"unknown layout {layout!r} (use 'fine'|'routed')")
    return max(8, -(-n // target_cap))


class IVFIndex:
    """Clustered approximate index; probes tunes recall like ef.

    layout="routed" picks the coarse cluster count search_routed needs
    (see _auto_clusters); the default fine layout serves per-query
    search() best."""

    def __init__(
        self,
        vectors: np.ndarray,
        *,
        num_clusters: int | None = None,
        target_cap: int = 128,
        metric: str | int = "l2",
        train_size: int = 100_000,
        seed: int = 1234,
        layout: str = "fine",
    ):
        self.metric = metric_id(metric)
        n = vectors.shape[0]
        if num_clusters is None:
            num_clusters = _auto_clusters(n, target_cap, layout)
        self.data = build_ivf_layout(
            vectors,
            num_clusters,
            metric=self.metric,
            train_size=train_size,
            seed=seed,
        )
        self.n = n

    @classmethod
    def from_device(
        cls,
        v_dev,
        *,
        num_clusters: int | None = None,
        target_cap: int = 128,
        metric: str | int = "l2",
        train_size: int = 262_144,
        iters: int = 20,
        seed: int = 1234,
        fill_chunk: int = 1024,
        layout: str = "fine",
    ) -> "IVFIndex":
        """Build from a device-resident base (vectors never visit the
        host). See build_ivf_layout_device."""
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        n = v_dev.shape[0]
        if num_clusters is None:
            num_clusters = _auto_clusters(n, target_cap, layout)
        self.data = build_ivf_layout_device(
            v_dev,
            num_clusters,
            metric=self.metric,
            train_size=train_size,
            iters=iters,
            seed=seed,
            fill_chunk=fill_chunk,
        )
        self.n = n
        return self

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        probes: int = 8,
        batch_size: int = 2048,
        rerank: int = 4,
        approx_probes: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        nq, d = queries.shape
        p = min(probes, self.data.num_clusters)
        batch_size = min(batch_size, max(nq, 1))
        out_i = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            q = queries[lo:hi].astype(np.float32)
            if hi - lo < batch_size:
                q = np.concatenate(
                    [q, np.zeros((batch_size - (hi - lo), d), np.float32)]
                )
            ii, dd = ivf_search(
                self.data, jnp.asarray(q), k=k, p=p, metric=self.metric,
                rerank=rerank, approx_probes=approx_probes,
            )
            out_i[lo:hi] = np.asarray(ii)[: hi - lo]
            out_d[lo:hi] = np.asarray(dd)[: hi - lo]
        return out_i, out_d

    def search_routed(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        probes: int = 16,
        shared: int = 96,
        tile: int = 256,
        batch_size: int = 4096,
        rerank: int = 4,
        with_stats: bool = False,
        preloaded=None,
        fallback: float | None = None,
    ):
        """Affinity-routed tile-shared probing (see ivf_routed_search).

        The whole pipeline — stage-1 scoring, affinity sort, per-tile
        union, fused scan, re-rank, unsort — is ONE jit per batch; only
        the result ids/dists leave the device. Larger batches give more
        homogeneous tiles (the sort has more to work with).

        fallback > 0 guarantees recall: queries whose granted-wish
        fraction falls below it are rerun through the exact per-query
        probe path (ivf_search) in one extra dispatch — the spill path of
        the reference's budgeted batch composition
        (query_router.hh:353-370). Defaults to 0.5: on healthy coarse
        layouts coverage is ~1.0 so the spill set is empty (no extra
        dispatch), while fine layouts get a recall floor instead of the
        measured 0.55 collapse at 1M x 64. Pass 0.0 to
        disable.
        """
        if fallback is None:
            fallback = 0.5
        if self.data.num_clusters > 2560:
            import sys as _sys

            print(
                f"# WARNING: search_routed on a fine layout "
                f"(C={self.data.num_clusters}): tile probe unions stop "
                "overlapping and coverage collapses (measured 0.45 cov / "
                "0.55 recall at 1M, C=7813) — build with layout='routed' "
                "(coarse C<=2048) for this serving mode",
                file=_sys.stderr,
            )
        nq, d = queries.shape
        p = min(probes, self.data.num_clusters)
        shared = min(shared, self.data.num_clusters)
        batch_size = max(tile, -(-min(batch_size, max(nq, 1)) // tile) * tile)
        if preloaded is not None:
            q_dev, nq_real = preloaded
            assert nq_real == nq
            # preload() padded with the caller's original batch_size; the
            # tile-rounded batch_size here may differ (non-power-of-two
            # tile/batch combos) — re-pad on device rather than assert
            nq_pad = -(-q_dev.shape[0] // batch_size) * batch_size
            if nq_pad != q_dev.shape[0]:
                q_dev = jnp.pad(
                    q_dev, ((0, nq_pad - q_dev.shape[0]), (0, 0))
                )
        else:
            nq_pad = -(-nq // batch_size) * batch_size
            q_all = np.zeros((nq_pad, d), np.float32)
            q_all[:nq] = queries.astype(np.float32)
            q_dev = jnp.asarray(q_all)
        parts = []
        for lo in range(0, nq_pad, batch_size):
            qb = jax.lax.dynamic_slice_in_dim(q_dev, lo, batch_size, 0)
            parts.append(
                ivf_routed_search(
                    self.data, qb, k=k, p=p, shared=shared, tile=tile,
                    metric=self.metric, rerank=rerank,
                )
            )
        if len(parts) == 1:
            all_i, all_d, cov, all_g = parts[0]
        else:
            all_i = jnp.concatenate([x[0] for x in parts], axis=0)
            all_d = jnp.concatenate([x[1] for x in parts], axis=0)
            cov = jnp.stack([x[2] for x in parts]).mean()
            all_g = jnp.concatenate([x[3] for x in parts], axis=0)
        out_i = np.asarray(all_i)[:nq]
        out_d = np.asarray(all_d)[:nq]
        n_fb = 0
        if fallback > 0:
            # np.asarray of a device array is read-only; the spill path
            # writes rows in place
            out_i = out_i.copy()
            out_d = out_d.copy()
            need = np.where(np.asarray(all_g)[:nq] < fallback)[0]
            n_fb = len(need)
            if n_fb:
                # pad the spill set to a power-of-two bucket to bound the
                # number of compiled shapes
                bucket = 1 << max(int(np.ceil(np.log2(n_fb))), 6)
                qs = np.zeros((bucket, d), np.float32)
                qs[:n_fb] = queries[need].astype(np.float32)
                fi, fd = ivf_search(
                    self.data, jnp.asarray(qs), k=k, p=p,
                    metric=self.metric, rerank=rerank,
                )
                out_i[need] = np.asarray(fi)[:n_fb]
                out_d[need] = np.asarray(fd)[:n_fb]
        if with_stats:
            return out_i, out_d, {
                "probe_coverage": float(np.asarray(cov)),
                "tiles": nq_pad // tile,
                "shared": shared,
                "fallback_queries": n_fb,
            }
        return out_i, out_d

    def preload(self, queries: np.ndarray, *, batch_size: int = 4096):
        """Stage queries in device memory once (cf. FastFlatIndex.preload),
        outside any timed region."""
        nq, d = queries.shape
        nq_pad = -(-nq // batch_size) * batch_size
        q_all = np.zeros((nq_pad, d), np.float32)
        q_all[:nq] = queries.astype(np.float32)
        q_dev = jnp.asarray(q_all)
        q_dev.block_until_ready()
        return q_dev, nq

    def routed_cost_counters(self, nq: int, k: int = 10, *, probes: int = 16,
                             shared: int = 96, tile: int = 256,
                             rerank: int = 4) -> dict:
        """Analytic cost of search_routed: stage 1 scores all C centroids
        per query; stage 2 gathers each tile's `shared` probe blocks once
        (amortized over `tile` queries) and scores all of them densely."""
        C, cap, d = self.data.num_clusters, self.data.cap, self.data.vectors.shape[1]
        P = min(shared, C)
        kk = min(max(rerank, 1) * k, P * cap)
        n_tiles = -(-nq // max(tile, 1))
        return {
            "distance_computations": nq * (C + P * cap + kk),
            "scanned_rows": nq * P * cap,
            "hbm_gather_bytes": n_tiles * P * cap * d * 2
            + nq * (C * d * 4 // max(nq, 1) + kk * d * 4),
            "ici_exchange_bytes": 0,
        }

    def cost_counters(self, nq: int, k: int = 10, *, probes: int = 8,
                      batch_size: int = 2048, rerank: int = 4) -> dict:
        """Analytic cost: every query scores all C centroids (stage 1),
        densely scans p probe blocks of cap rows (stage 2, bf16 gather),
        and exactly re-ranks rerank*k survivors in f32."""
        C, cap, d = self.data.num_clusters, self.data.cap, self.data.vectors.shape[1]
        p = min(probes, C)
        kk = min(max(rerank, 1) * k, p * cap)
        batches = -(-nq // max(batch_size, 1))
        return {
            "distance_computations": nq * (C + p * cap + kk),
            "scanned_rows": nq * p * cap,
            "hbm_gather_bytes": batches * C * d * 4
            + nq * (p * cap * d * 2 + kk * d * 4),
            "ici_exchange_bytes": 0,
        }
