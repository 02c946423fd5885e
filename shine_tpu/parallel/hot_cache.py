"""Hot-vertex replica cache.

The reference gives each compute node a DRAM cache of remote vertices with
optimistic lock-free reads and cooling-table eviction
(/root/reference/src/cache/cache.hh, cooling_table.hh): hot vertices stop
costing RDMA READs. The equivalent here replicates the hot vertices' rows
(vector + layer-0 neighborlist) onto every device so traversal steps
touching them are served from local memory instead of the owner-exchange
(parallel/sharded.py).

Design differences:
  * no per-access eviction machinery on device — the hot set is a static
    snapshot refreshed from access counters between batches (the
    cooling-table FIFO becomes an exponentially-decayed counter ranking,
    host-side);
  * membership lookup is a binary search over the sorted hot-id table
    (log H gathers, fixed shape) instead of a tagged-pointer hash chain;
  * admission = top-H by decayed access count (the reference admits with
    probability ADMISSION_RATIO=1% once full, constants.hh:11-13; counters
    achieve the same hot-set convergence deterministically).

Access counters are accumulated on the owning shard by a scatter-add of
expanded frontier ids — the analogue of ThreadStatistics cache hit/miss
counters (statistics.hh:160-167).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from shine_tpu.graph.soa import GraphSoA


class HotReplica(NamedTuple):
    """Replicated hot rows. hot_ids is sorted ascending; pad slots hold
    int32 max so searchsorted stays monotone."""

    hot_ids: jnp.ndarray  # (H,) i32 sorted, 2^31-1 pad
    hot_vecs: jnp.ndarray  # (H, d) f32 or bf16 (matches shard_graph rows=)
    hot_neighbors: jnp.ndarray  # (H, 2M) i32

    @property
    def capacity(self) -> int:
        return self.hot_ids.shape[0]


def select_hot_ids(
    graph: GraphSoA,
    capacity: int,
    counts: np.ndarray | None = None,
) -> np.ndarray:
    """Pick the hot set: by decayed access counts when available, else by
    layer-0 in-degree (hub vertices dominate traversal traffic — the same
    vertices the reference's cache converges to under CACHE_WARMUP)."""
    if counts is not None:
        score = counts.astype(np.float64)
    else:
        nb = graph.neighbors0
        score = np.bincount(nb[nb >= 0], minlength=graph.n).astype(np.float64)
        score[graph.levels >= 1] += score.max() + 1  # upper nodes always hot
    capacity = min(capacity, graph.n)
    top = np.argpartition(-score, capacity - 1)[:capacity]
    return np.sort(top).astype(np.int32)


def build_replica(
    graph: GraphSoA, hot_ids: np.ndarray, *, rows: str = "f32"
) -> HotReplica:
    """rows must match the sharded graph's row storage (shard_graph):
    replica hits must serve bit-the-same values the owner exchange would,
    so bf16 replicas store the ROUNDED rows."""
    vecs = graph.vectors[hot_ids].astype(np.float32)
    store = vecs
    if rows == "bf16":
        import ml_dtypes

        store = vecs.astype(ml_dtypes.bfloat16)
    elif rows != "f32":
        raise ValueError(f"replica rows must be f32|bf16, got {rows!r}")
    return HotReplica(
        hot_ids=jnp.asarray(hot_ids),
        hot_vecs=jnp.asarray(store),
        hot_neighbors=jnp.asarray(graph.neighbors0[hot_ids]),
    )


def replica_lookup(replica: HotReplica, ids: jnp.ndarray):
    """(rows, hit): rows into the replica tables where hit, else 0.

    Fixed-shape binary search (jnp.searchsorted over the sorted id table);
    the reference's optimistic hash-chain walk (cache.hh:102-144) without
    tags — the replica is immutable between refreshes, so there is nothing
    to race with.
    """
    safe = jnp.maximum(ids, 0)
    pos = jnp.searchsorted(replica.hot_ids, safe)
    pos = jnp.minimum(pos, replica.capacity - 1)
    hit = (replica.hot_ids[pos] == safe) & (ids >= 0)
    return jnp.where(hit, pos, 0), hit


class AccessCounter:
    """Exponentially-decayed per-vertex access counts (the cooling-table
    replacement). Device-side accumulation, host-side ranking."""

    def __init__(self, n: int, decay: float = 0.5):
        self.counts = np.zeros(n, dtype=np.float64)
        self.decay = decay

    @staticmethod
    @jax.jit
    def batch_counts(n_counts: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
        """Scatter-add one batch's accessed ids ((...,) i32, -1 pad)."""
        flat = ids.reshape(-1)
        safe = jnp.where(flat >= 0, flat, n_counts.shape[0])
        return n_counts.at[safe].add(1.0, mode="drop")

    def absorb(
        self,
        row_counts: np.ndarray,
        hot_ids: np.ndarray | None = None,
        hot_counts: np.ndarray | None = None,
    ) -> None:
        """Fold pre-aggregated device counts (one batch) into the decayed
        totals: row_counts are global-row accesses counted at the owning
        shards (cold traffic); hot_counts are replica-hit accesses keyed by
        the hot-id table (hits must keep entries hot, like Cache::get
        rescuing cooling entries, cache.hh:128-134)."""
        self.counts *= self.decay
        n = len(self.counts)
        self.counts += np.asarray(row_counts, dtype=np.float64)[:n]
        if hot_ids is not None and hot_counts is not None:
            h = np.asarray(hot_ids)
            valid = h < n  # pad slots hold int32 max
            self.counts[h[valid]] += np.asarray(hot_counts, np.float64)[valid]

    def update(self, accessed_ids: np.ndarray) -> None:
        dev = AccessCounter.batch_counts(
            jnp.zeros(len(self.counts), jnp.float32), jnp.asarray(accessed_ids)
        )
        self.counts = self.decay * self.counts + np.asarray(dev, dtype=np.float64)

    def refresh(
        self, graph: GraphSoA, capacity: int, *, rows: str = "f32"
    ) -> HotReplica:
        ids = select_hot_ids(graph, capacity, self.counts)
        return build_replica(graph, ids, rows=rows)
