"""Online (incremental) index: runtime inserts into a live graph.

The reference's defining capability is concurrent online insertion —
compute nodes stream vectors into the shared remote graph while it serves
queries (reference src/hnsw/hnsw.hh:40-251, scheduler.hh). The
equivalent here wraps the batched insert rounds of models/build.py: capacity is
pre-allocated (the analogue of the MN memory budget, constants.hh:7),
levels are pre-drawn for the whole capacity (replacing the remote FAA
allocator), and `add()` appends vectors + runs deterministic insert
rounds. `searcher()` snapshots the current graph for the batched device
search — snapshot-isolation queries, replacing the reference's lock-free
read protocol (readers there tolerate torn neighbor lists; here they see
a consistent prefix of the insert history).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from shine_tpu.config import METRIC_L2, HNSWParams
from shine_tpu.graph.soa import GraphSoA
from shine_tpu.models.build import init_build_state, insert_round


class DynamicHNSWIndex:
    """Append-only online index with pre-allocated capacity."""

    def __init__(
        self,
        dim: int,
        capacity: int,
        params: HNSWParams | None = None,
        *,
        level_cap: int = 12,
        batch_size: int = 512,
        ef: int | None = None,
        mesh=None,
    ):
        """mesh: a jax.sharding.Mesh makes insertion data-parallel over
        the chips (models/build.py:make_sharded_insert_round — the plan
        stage, which carries the ef_construction searches, scales with
        devices; the deterministic apply keeps every replica
        bit-identical). This is the reference's distributed concurrent
        insertion (CNs inserting into the shared remote graph,
        hnsw.hh:40-251) as SPMD rounds; `searcher()` then serves from a
        row-sharded ShardedIndex."""
        self.params = params or HNSWParams()
        self.capacity = capacity
        self.dim = dim
        self.batch_size = batch_size
        self.ef = ef or self.params.ef_construction
        self.mesh = mesh
        self._sharded_runs: dict = {}
        # bootstrap with a zero placeholder row; count starts at 1 only
        # after the first real vector arrives (see add())
        placeholder = np.zeros((capacity, dim), np.float32)
        self.st = init_build_state(placeholder, self.params, level_cap=level_cap)
        self.st = self.st._replace(count=jnp.int32(0))
        if mesh is not None:
            import jax
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P

            rep = NamedSharding(mesh, P())
            self.st = jax.tree.map(
                lambda a: jax.device_put(jnp.asarray(a), rep), self.st
            )
        self.count = 0

    def add(self, vectors: np.ndarray) -> None:
        """Insert a batch of vectors (ids are assigned consecutively)."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        b, d = vectors.shape
        assert d == self.dim
        if self.count + b > self.capacity:
            raise ValueError("capacity exceeded")
        lo = self.count
        vdev = jnp.asarray(vectors)
        from shine_tpu.ops.distance import squared_norms

        sq = squared_norms(vdev)  # ranking norms: HIGHEST precision
        if self.params.metric_id != METRIC_L2:
            sq = jnp.zeros(b, jnp.float32)
        self.st = self.st._replace(
            vectors=self.st.vectors.at[lo : lo + b].set(vdev),
            vec_sqnorms=self.st.vec_sqnorms.at[lo : lo + b].set(sq),
        )
        start = lo
        if self.count == 0:
            # node 0 bootstraps the index (reference hnsw.hh:56-84)
            self.st = self.st._replace(
                count=jnp.int32(1),
                entry_point=jnp.int32(0),
                entry_level=self.st.levels[0],
            )
            start = 1
        # ramp round sizes while the graph is small: within a round the
        # inserts cannot see each other (models/build.py), so early rounds
        # must stay comparable to the inserted prefix or first-round nodes
        # connect only to the bootstrap node
        blo = start
        while blo < lo + b:
            B = min(self.batch_size, max(16, blo))
            B = 1 << (B - 1).bit_length()  # pow2 -> few jit variants
            B = min(B, self.batch_size)
            bhi = min(blo + B, lo + b)
            ids = np.full(B, -1, np.int32)
            ids[: bhi - blo] = np.arange(blo, bhi, dtype=np.int32)
            # multiple of 8 so a 2/4/8-chip mesh splits it exactly and
            # sharded rounds stay bit-identical to single-chip ones
            B_up = max(8, min(B, 4 * B // max(self.params.M, 2) + 8))
            B_up = -(-B_up // 8) * 8
            if self.mesh is None:
                self.st = insert_round(
                    self.st,
                    jnp.asarray(ids),
                    ef=self.ef,
                    frontier=4,
                    max_add=2 * self.params.M,
                    metric=self.params.metric_id,
                    B_up=B_up,
                )
            else:
                self.st = self._run_sharded(B, B_up, ids)
            blo = bhi
        self.count = lo + b

    def _run_sharded(self, B: int, B_up: int, ids: np.ndarray):
        from shine_tpu.models.build import make_sharded_insert_round

        S = self.mesh.devices.size
        # same formula as device_build_graph (build.py): ceil division so
        # S * B_up_loc >= B_up (bit-identity to single-chip for any mesh
        # size), min-8 floor for lane efficiency, clamped to the local
        # batch slice (plan_round can't promote more rows than it holds)
        key = (B, min(max(1, B // S), max(8, -(-B_up // S))))
        run = self._sharded_runs.get(key)
        if run is None:
            run = make_sharded_insert_round(
                self.mesh,
                ef=self.ef,
                frontier=4,
                max_add=2 * self.params.M,
                metric=self.params.metric_id,
                B_up_loc=key[1],
            )
            self._sharded_runs[key] = run
        return run(self.st, jnp.asarray(ids))

    def snapshot(self) -> GraphSoA:
        """Consistent point-in-time graph over the inserted prefix."""
        n = self.count
        assert n > 0, "empty index"
        levels = np.asarray(self.st.levels[:n])
        upper_row = np.asarray(self.st.upper_row[:n])
        used = int(upper_row.max()) + 1 if (levels > 0).any() else 0
        top = int(np.asarray(self.st.entry_level))
        upper = np.asarray(self.st.upper_neighbors)[: max(used, 1), : max(top, 1)]
        return GraphSoA(
            params=self.params,
            vectors=np.asarray(self.st.vectors[:n]),
            levels=levels,
            neighbors0=np.asarray(self.st.neighbors0[:n]),
            upper_row=upper_row,
            upper_neighbors=np.ascontiguousarray(upper),
            entry_point=int(np.asarray(self.st.entry_point)),
            top_level=top,
        )

    def searcher(self, **kwargs):
        """An HNSWIndex (or, with a mesh, a ShardedIndex) over the
        current snapshot."""
        if self.mesh is not None:
            from shine_tpu.parallel.sharded import ShardedIndex

            return ShardedIndex(self.snapshot(), self.mesh, **kwargs)
        from shine_tpu.models.hnsw import HNSWIndex

        return HNSWIndex(self.snapshot(), **kwargs)
