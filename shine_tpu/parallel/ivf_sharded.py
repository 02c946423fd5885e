"""Multi-chip IVF: clusters sharded over the mesh.

Cluster blocks (models/ivf.py layout) are row-sharded over the devices so
index capacity scales with chips. Probing is per-query (see models/ivf.py):
every chip computes the same (B, p) probe set from the replicated
centroids, masks the probes it does not own, scans its owned blocks, and
the per-shard survivor sets merge with one `all_gather` + sort — the same
tiny merge traffic as the sharded flat scan. The exact f32 re-rank of the
survivors runs host-side against the numpy base (a few dozen rows per
query), so no replicated f32 copy of the base is needed on device.

Probe lanes are COMPACTED per shard (r3): each chip packs the (query,
cluster) wishes it owns into ~p/S lanes per query and scans only those,
with overflow served in further rounds of the same loop (exact — nothing
dropped; the _owner_rpc pattern minus the wire: queries and wishes are
replicated, so compaction is purely local and costs zero extra interconnect traffic).
Per-chip scanned lanes drop ~S/slack x vs the old masked full-width scan
(kept as probe_lanes="dense" for comparison; the reference analogue is
CNs reading only the rows they need, rdma_reads.hh:101-134).

Structural analogue: the reference's k-means placement routes *queries* to
compute nodes (/root/reference/src/cache/placement.hh); here the same
clustering decides where the *data* lives, and cross-shard probes are
served by their owner — the MN relay (memory_node.hh:211-362) becomes an
all_gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P
from jax.sharding import PartitionSpec as P_  # alias where `P` names the
# routed union width

from shine_tpu.config import METRIC_L2, metric_id
from shine_tpu.models.ivf import build_ivf_layout
from shine_tpu.ops.distance import pairwise_distance
from shine_tpu.parallel.mesh import SHARD_AXIS


def _make_routed_search(
    mesh: Mesh, p: int, kk: int, metric: int, C_loc: int, P: int, tile: int
):
    """Sharded tile-shared probing (models/ivf.ivf_routed_search over a
    cluster-sharded layout). Stage 1, the affinity sort, and the per-tile
    rank-major unions are replicated deterministic compute (every shard
    derives the identical plan from the replicated centroids — the same
    trick the reference uses for Placement, kmeans.hh:169 seed 1234);
    each shard then scans only the union lanes it owns and the per-shard
    survivor sets merge with one all_gather. HBM gather per shard is
    ~the owned fraction of each union; masked lanes clip to block 0 (a
    cache-hot repeated fetch, not a real read)."""
    S = mesh.devices.size

    def spmd(blocks, block_sq, block_ids, centroids, queries):
        B, d = queries.shape
        cap = blocks.shape[1]
        G = B // tile
        T = tile
        C = S * C_loc
        q = queries.astype(jnp.float32)
        qn = jnp.sum(q * q, axis=-1)
        scores = pairwise_distance(q, centroids, metric)  # (B, C)
        if C >= 4096:
            _, probes = jax.lax.approx_max_k(-scores, p, recall_target=0.999)
        else:
            _, probes = jax.lax.top_k(-scores, p)
        if p > 1:
            perm = jnp.argsort(probes[:, 1], stable=True)
            perm = perm[jnp.argsort(probes[perm, 0], stable=True)]
        else:
            perm = jnp.argsort(probes[:, 0], stable=True)
        inv = jnp.argsort(perm, stable=True)
        q_s = q[perm]
        qn_s = qn[perm]
        probes_s = probes[perm].reshape(G, T, p)
        pos = jnp.broadcast_to(
            jnp.arange(T * p, dtype=jnp.int32).reshape(p, T).T, (G, T, p)
        )
        minpos = jnp.full((G, C), jnp.int32(2**30))
        minpos = minpos.at[jnp.arange(G)[:, None, None], probes_s].min(pos)
        neg, cols = jax.lax.top_k(-minpos, P)  # (G, P) global cluster ids
        colmask = neg > -(2**30)

        # owned lanes COMPACTED (round-robin ownership, see __init__):
        # each shard packs the union columns it owns into PL ~ P/S * slack
        # lanes per tile and scans only those; overflow re-queues exactly
        # (the per-query compact path's pattern at tile granularity)
        my = jax.lax.axis_index(SHARD_AXIS)
        mine = colmask & ((cols % S) == my)
        local = cols // S
        PL = max(1, -(-int(P * 2.0) // S))
        qf = q_s.reshape(G, T, d).astype(jnp.bfloat16)
        qn_t = qn_s.reshape(G, T)
        rowg = jnp.arange(G, dtype=jnp.int32)[:, None]

        def cond(state):
            todo = state[0].any().astype(jnp.int32)
            return jax.lax.psum(todo, SHARD_AXIS) > 0

        def body(state):
            pending, bd, bi, rounds = state
            rank = jnp.cumsum(pending.astype(jnp.int32), axis=1) - 1
            take = pending & (rank < PL)
            slot = jnp.where(take, rank, PL)
            ccols = (
                jnp.zeros((G, PL + 1), jnp.int32)
                .at[rowg, slot]
                .set(jnp.where(take, local, 0), mode="drop")[:, :PL]
            )
            valid = (
                jnp.zeros((G, PL + 1), bool)
                .at[rowg, slot]
                .set(take, mode="drop")[:, :PL]
            )
            blk = blocks[ccols]  # (G, PL, cap, d)
            sqs = block_sq[ccols]
            ids = jnp.where(valid[..., None], block_ids[ccols], -1)
            dots = jnp.einsum(
                "gtd,gpcd->gtpc", qf, blk,
                preferred_element_type=jnp.float32,
            )
            if metric == METRIC_L2:
                dd = qn_t[..., None, None] - 2.0 * dots + sqs[:, None]
            else:
                dd = 1.0 - dots
            dd = jnp.where(
                ids[:, None] >= 0, dd, jnp.inf
            ).reshape(G, T, PL * cap)
            fid = jnp.broadcast_to(
                ids.reshape(G, 1, PL * cap), (G, T, PL * cap)
            )
            md = jnp.concatenate([bd, dd], axis=-1)
            mi = jnp.concatenate([bi, fid], axis=-1)
            nd, sel = jax.lax.top_k(-md, kk)
            return (
                pending & ~take,
                -nd,
                jnp.take_along_axis(mi, sel, axis=-1),
                rounds + 1,
            )

        init = (
            mine,
            jnp.full((G, T, kk), jnp.inf, jnp.float32),
            jnp.full((G, T, kk), -1, jnp.int32),
            jnp.int32(0),
        )
        _, bd, bi, rounds = jax.lax.while_loop(cond, body, init)
        nd = -bd.reshape(B, kk)
        cand = bi.reshape(B, kk)
        # merge per-shard survivors (each global survivor is in its owning
        # shard's top-kk, so the union contains the global top-kk)
        all_d = jax.lax.all_gather(-nd, SHARD_AXIS)  # (S, B, kk)
        all_i = jax.lax.all_gather(cand, SHARD_AXIS)
        all_d = jnp.moveaxis(all_d, 0, 1).reshape(B, S * kk)
        all_i = jnp.moveaxis(all_i, 0, 1).reshape(B, S * kk)
        key_i = jnp.where(all_i < 0, jnp.int32(2**31 - 1), all_i)
        md, _, mi = jax.lax.sort((all_d, key_i, all_i), dimension=1, num_keys=2)
        # undo the affinity sort so the host re-rank aligns with queries
        return md[:, :kk][inv], mi[:, :kk][inv]

    @jax.jit
    def run(blocks, block_sq, block_ids, centroids, queries):
        fn = jax.shard_map(
            spmd,
            mesh=mesh,
            in_specs=(P_(SHARD_AXIS), P_(SHARD_AXIS), P_(SHARD_AXIS), P_(), P_()),
            out_specs=(P_(), P_()),
            check_vma=False,
        )
        return fn(blocks, block_sq, block_ids, centroids, queries)

    return run


def _make_search_compact(
    mesh: Mesh, p: int, kk: int, metric: int, C_loc: int, slack: float = 2.0
):
    """Owned-probe lane compaction (see module docstring): every shard
    derives the same (B, p) probe plan from the replicated centroids,
    keeps only its owned wishes, and packs them into PL ~ slack*p/S lanes
    per query; a while_loop serves overflowing queries in further rounds
    (exact). Scanned einsum lanes per chip drop from B*p to
    rounds*B*PL ~ B*p/(S/slack). Returns (dists, ids, rounds,
    scanned_lanes)."""
    S = mesh.devices.size
    PL = max(1, -(-int(p * slack) // S))

    def spmd(blocks, block_sq, block_ids, centroids, queries):
        B, d = queries.shape
        cap = blocks.shape[1]
        q = queries.astype(jnp.float32)
        qn = jnp.sum(q * q, axis=-1)
        scores = pairwise_distance(q, centroids, metric)
        _, probes = jax.lax.top_k(-scores, p)  # (B, p) global, replicated
        my = jax.lax.axis_index(SHARD_AXIS)
        # round-robin ownership (see ShardedIVFIndex.__init__)
        mine = (probes % S) == my
        local = probes // S
        qb = q.astype(jnp.bfloat16)
        rowb = jnp.arange(B, dtype=jnp.int32)[:, None]

        def cond(state):
            todo = state[0].any().astype(jnp.int32)
            return jax.lax.psum(todo, SHARD_AXIS) > 0

        def body(state):
            pending, bd, bi, rounds, lanes = state
            rank = jnp.cumsum(pending.astype(jnp.int32), axis=1) - 1
            take = pending & (rank < PL)
            slot = jnp.where(take, rank, PL)  # PL = drop column
            cols = (
                jnp.zeros((B, PL + 1), jnp.int32)
                .at[rowb, slot]
                .set(jnp.where(take, local, 0), mode="drop")[:, :PL]
            )
            valid = (
                jnp.zeros((B, PL + 1), bool)
                .at[rowb, slot]
                .set(take, mode="drop")[:, :PL]
            )
            blk = blocks[cols]  # (B, PL, cap, d) bf16 — owned lanes only
            sqs = block_sq[cols]
            ids = jnp.where(valid[..., None], block_ids[cols], -1)
            dots = jnp.einsum(
                "bd,bpcd->bpc", qb, blk, preferred_element_type=jnp.float32
            )
            if metric == METRIC_L2:
                dd = qn[:, None, None] - 2.0 * dots + sqs
            else:
                dd = 1.0 - dots
            dd = jnp.where(ids >= 0, dd, jnp.inf).reshape(B, PL * cap)
            fid = ids.reshape(B, PL * cap)
            # fold into the running top-kk ((query, cluster) pairs are
            # scanned at most once, so no dedup is needed)
            md = jnp.concatenate([bd, dd], axis=1)
            mi = jnp.concatenate([bi, fid], axis=1)
            nd, sel = jax.lax.top_k(-md, kk)
            return (
                pending & ~take,
                -nd,
                jnp.take_along_axis(mi, sel, axis=1),
                rounds + 1,
                lanes + B * PL,
            )

        init = (
            mine,
            jnp.full((B, kk), jnp.inf, jnp.float32),
            jnp.full((B, kk), -1, jnp.int32),
            jnp.int32(0),
            jnp.int32(0),
        )
        _, bd, bi, rounds, lanes = jax.lax.while_loop(cond, body, init)
        all_d = jax.lax.all_gather(bd, SHARD_AXIS)  # (S, B, kk)
        all_i = jax.lax.all_gather(bi, SHARD_AXIS)
        all_d = jnp.moveaxis(all_d, 0, 1).reshape(B, S * kk)
        all_i = jnp.moveaxis(all_i, 0, 1).reshape(B, S * kk)
        key_i = jnp.where(all_i < 0, jnp.int32(2**31 - 1), all_i)
        md, _, mi = jax.lax.sort((all_d, key_i, all_i), dimension=1, num_keys=2)
        return (
            md[:, :kk], mi[:, :kk], rounds,
            jax.lax.psum(lanes, SHARD_AXIS),
        )

    @jax.jit
    def run(blocks, block_sq, block_ids, centroids, queries):
        fn = jax.shard_map(
            spmd,
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(), P()),
            out_specs=(P(), P(), P(), P()),
            check_vma=False,
        )
        return fn(blocks, block_sq, block_ids, centroids, queries)

    return run


def _make_search(mesh: Mesh, p: int, kk: int, metric: int, C_loc: int):
    S = mesh.devices.size

    def spmd(blocks, block_sq, block_ids, centroids, queries):
        B, d = queries.shape
        cap = blocks.shape[1]
        q = queries.astype(jnp.float32)
        qn = jnp.sum(q * q, axis=-1)
        scores = pairwise_distance(q, centroids, metric)  # (B, C) replicated
        _, probes = jax.lax.top_k(-scores, p)  # (B, p) global cluster ids
        my = jax.lax.axis_index(SHARD_AXIS)
        # round-robin ownership (see ShardedIVFIndex.__init__)
        mine = (probes % S) == my
        safe = jnp.clip(probes // S, 0, C_loc - 1)
        blk = blocks[safe]  # (B, p, cap, d) bf16 — owned lanes real
        sqs = block_sq[safe]
        ids = jnp.where(mine[:, :, None], block_ids[safe], -1)
        dots = jnp.einsum(
            "bd,bpcd->bpc", q.astype(jnp.bfloat16), blk,
            preferred_element_type=jnp.float32,
        )
        if metric == METRIC_L2:
            dd = qn[:, None, None] - 2.0 * dots + sqs
        else:
            dd = 1.0 - dots
        dd = jnp.where(ids >= 0, dd, jnp.inf).reshape(B, p * cap)
        fid = ids.reshape(B, p * cap)
        nd, sel = jax.lax.top_k(-dd, kk)
        cand = jnp.take_along_axis(fid, sel, axis=1)  # (B, kk) local survivors
        all_d = jax.lax.all_gather(-nd, SHARD_AXIS)  # (S, B, kk)
        all_i = jax.lax.all_gather(cand, SHARD_AXIS)
        all_d = jnp.moveaxis(all_d, 0, 1).reshape(B, S * kk)
        all_i = jnp.moveaxis(all_i, 0, 1).reshape(B, S * kk)
        key_i = jnp.where(all_i < 0, jnp.int32(2**31 - 1), all_i)
        md, _, mi = jax.lax.sort((all_d, key_i, all_i), dimension=1, num_keys=2)
        return md[:, :kk], mi[:, :kk]

    @jax.jit
    def run(blocks, block_sq, block_ids, centroids, queries):
        fn = jax.shard_map(
            spmd,
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return fn(blocks, block_sq, block_ids, centroids, queries)

    return run


class ShardedIVFIndex:
    """Cluster-sharded approximate index over a device mesh."""

    def __init__(
        self,
        vectors: np.ndarray,
        mesh: Mesh,
        *,
        num_clusters: int | None = None,
        target_cap: int = 128,
        metric: str | int = "l2",
        train_size: int = 100_000,
        seed: int = 1234,
    ):
        self.metric = metric_id(metric)
        self.mesh = mesh
        S = mesh.devices.size
        n = vectors.shape[0]
        if num_clusters is None:
            num_clusters = max(8, -(-n // target_cap))
        num_clusters = -(-num_clusters // S) * S  # pad C to the mesh
        data = build_ivf_layout(
            vectors, num_clusters, metric=self.metric,
            train_size=train_size, seed=seed,
        )
        # ROUND-ROBIN cluster ownership (owner = c % S, local = c // S):
        # probe sets are spatially contiguous (clusters are spatially
        # relabeled for the routed affinity sort), so contiguous-range
        # ownership would hand most of a query's wishes to ONE shard and
        # the compact probe lanes would degenerate to multi-round serving;
        # dealing clusters mod-S spreads every query's p wishes ~evenly
        # (the reference's round-robin row partitioning across MNs,
        # io/read_data.hh:57-77, applied at cluster granularity). The
        # physical array order interleaves so shard s's slice holds
        # clusters {s, s+S, s+2S, ...}.
        C = num_clusters
        order = np.argsort(
            (np.arange(C) % S) * (C // S) + np.arange(C) // S
        ).astype(np.int32)
        row_sh = NamedSharding(mesh, P(SHARD_AXIS))
        rep = NamedSharding(mesh, P())
        self.blocks = jax.device_put(data.blocks[order], row_sh)
        self.block_sq = jax.device_put(data.block_sq[order], row_sh)
        self.block_ids = jax.device_put(data.block_ids[order], row_sh)
        self.centroids = jax.device_put(data.centroids, rep)
        self.C = num_clusters
        self.C_loc = num_clusters // S
        self.cap = data.cap
        self.base = np.ascontiguousarray(vectors, dtype=np.float32)
        self.n = n
        self.rpc_rounds = 0  # compact probe-lane rounds
        self.scanned_lanes = 0  # cluster-total probe lanes actually scanned
        self._runs: dict = {}

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        probes: int = 8,
        batch_size: int = 2048,
        rerank: int = 4,
        probe_lanes: str = "compact",
    ) -> tuple[np.ndarray, np.ndarray]:
        """probe_lanes="compact" (default): each shard scans only the
        probe wishes it owns, packed into ~p/S lanes per query with exact
        multi-round overflow (_make_search_compact) — cluster-total
        scanned lanes track B*p instead of S*B*p. "dense" keeps the old
        masked full-width scan for comparison."""
        if probe_lanes not in ("compact", "dense"):
            raise ValueError("probe_lanes must be 'compact' or 'dense'")
        compact = probe_lanes == "compact"
        nq, d = queries.shape
        p = min(probes, self.C)
        kk = min(max(rerank, 1) * k, p * self.cap)
        batch_size = min(batch_size, max(nq, 1))
        key = (p, kk, batch_size, compact)
        if key not in self._runs:
            self._runs[key] = (
                _make_search_compact(
                    self.mesh, p, kk, self.metric, self.C_loc
                )
                if compact
                else _make_search(self.mesh, p, kk, self.metric, self.C_loc)
            )
        run = self._runs[key]
        rep = NamedSharding(self.mesh, P())
        out_i = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            q = queries[lo:hi].astype(np.float32)
            if hi - lo < batch_size:
                q = np.concatenate(
                    [q, np.zeros((batch_size - (hi - lo), d), np.float32)]
                )
            out = run(
                self.blocks, self.block_sq, self.block_ids, self.centroids,
                jax.device_put(jnp.asarray(q), rep),
            )
            if compact:
                _, cand, rounds, lanes = out
                self.rpc_rounds += int(np.asarray(rounds))
                self.scanned_lanes += int(np.asarray(lanes))
            else:
                _, cand = out
                self.scanned_lanes += (
                    self.mesh.devices.size * batch_size * p
                )
            cand = np.asarray(cand)[: hi - lo]  # (b, kk)
            # exact host-side f32 re-rank of the survivors
            ii, dd = self._host_rerank(cand, q[: hi - lo], k)
            out_i[lo:hi] = ii
            out_d[lo:hi] = dd
        return out_i, out_d

    def _host_rerank(self, cand, q, k):
        """Exact f32 re-rank of device survivors against the numpy base."""
        safe = np.maximum(cand, 0)
        cv = self.base[safe]
        dots = np.einsum("bd,bkd->bk", q, cv)
        if self.metric == METRIC_L2:
            dist = (q * q).sum(-1)[:, None] - 2.0 * dots + (cv * cv).sum(-1)
        else:
            dist = 1.0 - dots
        dist = np.where(cand >= 0, dist, np.inf)
        ordk = np.lexsort(
            (np.where(cand < 0, 2**31 - 1, cand), dist), axis=1
        )[:, :k]
        return (
            np.take_along_axis(cand, ordk, axis=1),
            np.take_along_axis(dist, ordk, axis=1),
        )

    def search_routed(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        probes: int = 16,
        shared: int = 96,
        tile: int = 64,
        batch_size: int = 4096,
        rerank: int = 4,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Tile-shared probing over the cluster-sharded layout (see
        _make_routed_search). Results match the single-chip routed path's
        probe semantics; survivors re-rank exactly on the host."""
        nq, d = queries.shape
        p = min(probes, self.C)
        P = min(shared, self.C)
        kk = min(max(rerank, 1) * k, P * self.cap)
        batch_size = max(tile, -(-min(batch_size, max(nq, 1)) // tile) * tile)
        key = ("routed", p, kk, P, tile, batch_size)
        if key not in self._runs:
            self._runs[key] = _make_routed_search(
                self.mesh, p, kk, self.metric, self.C_loc, P, tile
            )
        run = self._runs[key]
        rep = NamedSharding(self.mesh, P_())
        out_i = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            q = queries[lo:hi].astype(np.float32)
            if hi - lo < batch_size:
                q = np.concatenate(
                    [q, np.zeros((batch_size - (hi - lo), d), np.float32)]
                )
            _, cand = run(
                self.blocks, self.block_sq, self.block_ids, self.centroids,
                jax.device_put(jnp.asarray(q), rep),
            )
            cand = np.asarray(cand)[: hi - lo]
            ii, dd = self._host_rerank(cand, q[: hi - lo], k)
            out_i[lo:hi] = ii
            out_d[lo:hi] = dd
        return out_i, out_d

    def routed_cost_counters(self, nq: int, k: int = 10, *, probes: int = 16,
                             shared: int = 96, tile: int = 64,
                             rerank: int = 4) -> dict:
        """Analytic routed cost: the plan (stage 1 + sort + unions) is
        replicated on every shard; union blocks are fetched once per tile
        by their owners; per-shard survivors merge over the interconnect; exact re-rank
        on the host."""
        S = self.mesh.devices.size
        P = min(shared, self.C)
        kk = min(max(rerank, 1) * k, P * self.cap)
        d = self.base.shape[1]
        n_tiles = -(-nq // max(tile, 1))
        return {
            "distance_computations": nq * (self.C * S + P * self.cap * S + kk),
            "scanned_rows": nq * P * self.cap,
            "hbm_gather_bytes": n_tiles * P * self.cap * d * 2
            + nq * kk * d * 4,
            "ici_exchange_bytes": nq * d * 4 * (S - 1)
            + nq * kk * 8 * (S - 1),
        }

    def cost_counters(self, nq: int, k: int = 10, *, probes: int = 8,
                      batch_size: int = 2048, rerank: int = 4) -> dict:
        """Cluster-total analytic cost: centroid scoring is replicated on
        every shard; probed blocks are scanned by their owning shard; the
        (B, kk) candidate lanes are merged over the interconnect; the exact re-rank runs
        on the host against the id-ordered base."""
        S = self.mesh.devices.size
        p = min(probes, self.C)
        kk = min(max(rerank, 1) * k, p * self.cap)
        d = self.base.shape[1]
        batches = -(-nq // max(batch_size, 1))
        return {
            "distance_computations": nq * (self.C * S + p * self.cap + kk),
            "scanned_rows": nq * p * self.cap,
            "hbm_gather_bytes": batches * self.C * d * 4 * S
            + nq * (p * self.cap * d * 2 + kk * d * 4),
            "ici_exchange_bytes": nq * d * 4 * (S - 1) + nq * kk * 8 * (S - 1),
        }
