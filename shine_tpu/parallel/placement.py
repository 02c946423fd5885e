"""Query-to-shard placement: balanced k-means over upper-layer vertices.

The reference routes each query to the compute node whose cache most likely
holds the query's region: it BFS-fetches >=500 upper-level vertices, runs
*balanced* k-means with k = num CNs (deterministic seed so every CN computes
the identical placement), and keeps a centroid -> CN mapping
(reference src/cache/placement.hh:22-106, kmeans.hh). This rebuild
keeps the same math — farthest-point init, Lloyd iterations, penalty-based
balancing (the "Balanced k-means revisited" scheme, kmeans.hh:259-377) —
but vectorized in JAX: one (n, k) distance matmul per iteration
instead of per-point scalar loops.

Placement feeds two consumers:
  * the QueryRouter (affinity-ordered batch composition, router.py);
  * cluster-sharded graph layouts, where shard = centroid id (the analogue
    of the reference's cache-locality goal).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from shine_tpu.config import METRIC_L2
from shine_tpu.graph.soa import GraphSoA
from shine_tpu.ops.distance import pairwise_distance

KMEANS_SEED = 1234  # deterministic like the reference (kmeans.hh:169)


def _init_centroids(points: jnp.ndarray, k: int, seed: int) -> jnp.ndarray:
    """Farthest-point init (the reference's k-means++ variant,
    kmeans.hh:163-197): start from a seeded point, repeatedly add the point
    farthest from the current centroid set."""
    n = points.shape[0]
    key = jax.random.PRNGKey(seed)
    first = jax.random.randint(key, (), 0, n)
    # vectorized: maintain per-point min distance to the chosen set
    cents = jnp.zeros((k, points.shape[1]), points.dtype).at[0].set(points[first])
    mind = jnp.sum((points - points[first][None, :]) ** 2, axis=1)

    def body(i, carry):
        cents, mind = carry
        nxt = jnp.argmax(mind)
        cents = cents.at[i].set(points[nxt])
        d = jnp.sum((points - points[nxt][None, :]) ** 2, axis=1)
        return cents, jnp.minimum(mind, d)

    cents, _ = jax.lax.fori_loop(1, k, body, (cents, mind))
    return cents


@partial(jax.jit, static_argnames=("k", "iters", "seed"))
def _lloyd(points: jnp.ndarray, *, k: int, iters: int, seed: int):
    """Plain Lloyd iterations (kmeans.hh:93-137), one (n, k) distance
    matmul per iteration."""
    points = points.astype(jnp.float32)
    cents = _init_centroids(points, k, seed)

    def body(i, cents):
        d = pairwise_distance(points, cents, METRIC_L2)  # (n, k)
        assign = jnp.argmin(d, axis=1)
        one_hot = jax.nn.one_hot(assign, k, dtype=jnp.float32)  # (n, k)
        counts = one_hot.sum(axis=0)  # (k,)
        sums = one_hot.T @ points  # (k, d)
        new_cents = sums / jnp.maximum(counts, 1.0)[:, None]
        return jnp.where(counts[:, None] > 0, new_cents, cents)

    cents = jax.lax.fori_loop(0, iters, body, cents)
    d = pairwise_distance(points, cents, METRIC_L2)
    return cents, jnp.argmin(d, axis=1).astype(jnp.int32)


def capacity_assign(d: np.ndarray, cap: int) -> np.ndarray:
    """Deterministic capacity-constrained assignment: each point goes to
    its nearest centroid that still has room (<= cap points each), points
    taken nearest-first per cluster. This rebuild's replacement for the
    reference's sequential penalty-based balanced k-means
    (kmeans.hh:259-377) — an O(k^2) sweep of vectorized numpy instead of a
    per-point scalar loop, with a hard balance guarantee."""
    n, k = d.shape
    ranked = np.argsort(d, axis=1, kind="stable")  # (n, k) choices
    assign = np.full(n, -1, dtype=np.int32)
    room = np.full(k, cap, dtype=np.int64)
    for r in range(k):
        un = assign < 0
        if not un.any():
            break
        choice = ranked[:, r]
        for c in range(k):
            if room[c] <= 0:
                continue
            cand = np.where(un & (choice == c))[0]
            if len(cand) == 0:
                continue
            take = cand[np.argsort(d[cand, c], kind="stable")[: room[c]]]
            assign[take] = c
            room[c] -= len(take)
            un[take] = False
    assert (assign >= 0).all(), "capacity too small for point count"
    return assign


def kmeans(
    points: jnp.ndarray,  # (n, d)
    *,
    k: int,
    iters: int = 100,
    balanced: bool = True,
    seed: int = KMEANS_SEED,
):
    """Returns (centroids (k, d), assignment (n,)). balanced=True enforces
    cluster sizes <= ceil(n/k) via capacity_assign and refines centroids
    under that constraint."""
    cents, assign = _lloyd(points, k=k, iters=iters, seed=seed)
    if not balanced:
        return cents, assign
    pts = np.asarray(points, dtype=np.float32)
    n = pts.shape[0]
    cap = -(-n // k)
    cents = np.array(cents)  # writable copy
    for _ in range(3):  # constrained refinement rounds
        d = np.asarray(pairwise_distance(jnp.asarray(pts), jnp.asarray(cents)))
        a = capacity_assign(d, cap)
        for c in range(k):
            sel = a == c
            if sel.any():
                cents[c] = pts[sel].mean(axis=0)
    return jnp.asarray(cents), jnp.asarray(a)


class Placement:
    """Centroid table mapping queries to shards.

    Built from the graph's upper-layer vertices (the reference fetches the
    highest levels until >=500 vertices, placement.hh:78-106; the SoA
    layout already has them materialized — no BFS needed).
    """

    def __init__(self, graph: GraphSoA, num_shards: int, *, min_points: int = 500):
        levels = graph.levels
        # take the highest levels until enough points, like fetch_level
        lvl = int(levels.max())
        sel = levels >= lvl
        while lvl > 1 and sel.sum() < min_points:
            lvl -= 1
            sel = levels >= lvl
        pts = graph.vectors[sel]
        if pts.shape[0] < num_shards:
            pts = graph.vectors[: max(num_shards, min(graph.n, min_points))]
        cents, _ = kmeans(jnp.asarray(pts), k=num_shards, iters=50)
        self.centroids = np.asarray(cents)
        self.num_shards = num_shards

    def closest_shards(self, queries: np.ndarray) -> np.ndarray:
        """(q, num_shards) shard ids ranked nearest-first (the min-heap of
        (CN, distance) the reference returns, placement.hh:63-72)."""
        d = np.asarray(
            pairwise_distance(jnp.asarray(queries), jnp.asarray(self.centroids))
        )
        return np.argsort(d, axis=1, kind="stable").astype(np.int32)

    def shard_of(self, queries: np.ndarray) -> np.ndarray:
        d = np.asarray(
            pairwise_distance(jnp.asarray(queries), jnp.asarray(self.centroids))
        )
        return np.argmin(d, axis=1).astype(np.int32)
