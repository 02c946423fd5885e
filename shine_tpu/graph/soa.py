"""Structure-of-arrays HNSW graph.

The accelerator-native layout replacing the reference's variable-size remote node
records (/root/reference/src/node/node.hh:10-19 — header | uid | level |
components | per-level neighbor lists). Variable-degree, variable-level
nodes become fixed-shape padded tensors (SURVEY.md §7.1):

    vectors          (N, d)  float32   the components
    levels           (N,)    int32     node max level (0-based)
    neighbors0       (N, 2M) int32     level-0 adjacency, -1 padded
    upper_row        (N,)    int32     row into upper_neighbors, -1 if lvl==0
    upper_neighbors  (U, L, M) int32   adjacency for levels 1..L, -1 padded
    entry_point / top_level             scalars (reference keeps the EP
                                        pointer at MN0 offset 8,
                                        rdma_reads.hh:74-99)

Node ids are plain row indices; under sharding they become
(shard, local_row) exactly like the reference's 16-bit MN id + 48-bit offset
RemotePtr (remote_pointer.hh:7-29).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from shine_tpu.config import HNSWParams


@dataclasses.dataclass
class GraphSoA:
    params: HNSWParams
    vectors: np.ndarray
    levels: np.ndarray
    neighbors0: np.ndarray
    upper_row: np.ndarray
    upper_neighbors: np.ndarray
    entry_point: int
    top_level: int

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def level_cap(self) -> int:
        return self.upper_neighbors.shape[1]

    def validate(self) -> None:
        """Graph invariants (the rebuild's unit-level answer to the
        reference's assertion-based checking, SURVEY.md §4)."""
        n = self.n
        M, M0 = self.params.M_max, self.params.M_max0
        assert self.neighbors0.shape == (n, M0)
        assert self.levels.min() >= 0 and self.levels.max() == self.top_level
        assert 0 <= self.entry_point < n
        assert self.levels[self.entry_point] == self.top_level
        # ids in range, no self loops on level 0
        nb = self.neighbors0
        assert nb.max() < n
        valid = nb >= 0
        rows = np.broadcast_to(np.arange(n)[:, None], nb.shape)
        assert not np.any(valid & (nb == rows)), "self-loop at level 0"
        # upper rows consistent
        up = self.upper_row
        assert np.all((up >= 0) == (self.levels > 0))
        used = up[up >= 0]
        assert used.max(initial=-1) < self.upper_neighbors.shape[0]
        assert len(np.unique(used)) == len(used)
        # neighbors at level l must themselves reach level l
        for l in range(1, self.top_level + 1):
            has = self.levels >= l
            ids = np.where(has)[0]
            ls = self.upper_neighbors[up[ids], l - 1]
            ok = (ls < 0) | ((ls < n) & (self.levels[np.clip(ls, 0, n - 1)] >= l))
            assert ok.all(), f"level-{l} edge to a lower-level node"
        assert self.upper_neighbors.shape[2] == M


def build_graph(
    vectors: np.ndarray,
    params: HNSWParams,
    *,
    threads: int = 0,
    level_cap: int = 12,
) -> GraphSoA:
    """Build with the native multithreaded builder (reference insert
    semantics, hnsw.hh:40-251)."""
    import os

    from shine_tpu import native

    lib = native.load()
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 32)
    M = params.M
    # expected fraction of nodes with level >= 1 is 1/M under the geometric
    # draw (hnsw.hh:309-321); 4x headroom plus a constant floor
    upper_cap = int(4 * n / max(M, 2)) + 1024
    levels = np.empty(n, dtype=np.int32)
    neighbors0 = np.empty((n, 2 * M), dtype=np.int32)
    upper_row = np.empty(n, dtype=np.int32)
    upper_neighbors = np.empty((upper_cap, level_cap, M), dtype=np.int32)
    meta = np.zeros(3, dtype=np.int64)
    rc = lib.shine_hnsw_build(
        vectors,
        n,
        d,
        M,
        params.ef_construction,
        params.seed,
        params.metric_id,
        threads,
        upper_cap,
        level_cap,
        levels,
        neighbors0,
        upper_row,
        upper_neighbors.reshape(-1),
        meta,
    )
    if rc != 0:
        raise RuntimeError("upper-row capacity overflow during build")
    entry_point, top_level, used = int(meta[0]), int(meta[1]), int(meta[2])
    # compact the upper table to the used prefix, trimmed to top_level
    lcap = max(top_level, 1)
    upper_neighbors = np.ascontiguousarray(upper_neighbors[:used, :lcap])
    return GraphSoA(
        params=params,
        vectors=vectors,
        levels=levels,
        neighbors0=neighbors0,
        upper_row=upper_row,
        upper_neighbors=upper_neighbors,
        entry_point=entry_point,
        top_level=top_level,
    )


def host_search(
    graph: GraphSoA,
    queries: np.ndarray,
    k: int,
    ef: int,
    *,
    threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Native host-side k-NN over the graph — the semantic oracle the
    batched device search is tested against (reference knn, hnsw.hh:253-307)."""
    import os

    from shine_tpu import native

    lib = native.load()
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    nq = queries.shape[0]
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 32)
    results = np.empty((nq, k), dtype=np.int32)
    dists = np.empty((nq, k), dtype=np.float32)
    lib.shine_hnsw_search(
        graph.vectors,
        graph.n,
        graph.dim,
        graph.params.M,
        graph.params.metric_id,
        graph.levels,
        graph.neighbors0,
        graph.upper_row,
        np.ascontiguousarray(graph.upper_neighbors.reshape(-1)),
        graph.level_cap,
        graph.entry_point,
        graph.top_level,
        queries,
        nq,
        k,
        ef,
        threads,
        results.reshape(-1),
        dists.reshape(-1),
    )
    return results, dists


def estimate_index_bytes(n: int, d: int, params: HNSWParams) -> int:
    """Expected index size under the geometric level distribution — the
    analogue of the reference's estimate_index_size (hnsw.hh:309-321), used
    to size the hot-vertex replica budget."""
    M = params.M
    per_node = d * 4 + 4 + 4 + 2 * M * 4  # vector + level + upper_row + L0
    upper_frac = 1.0 / (M - 1)  # sum of P(level >= l) for l >= 1
    per_upper = params.M_max * 4
    return int(n * (per_node + upper_frac * per_upper * math.e))
