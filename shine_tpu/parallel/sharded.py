"""Multi-device sharded HNSW search (SPMD over a 1-D device mesh).

Replaces the reference's disaggregated CN/MN split
(reference src/compute_node.cc, src/memory_node.hh): every device holds
one row-range shard of the layer-0 graph (the MN role) and advances one
slice of the query batch (the CN role). The reference's one-sided RDMA READ
of a remote node (src/rdma/rdma_reads.hh:9-38) becomes two collectives
per traversal step:

  1. frontier neighborlists: `all_gather` the (tiny, int32) frontier ids,
     the owning shard gathers its `neighbors0` rows, `psum_scatter` routes
     each row back to the requesting device;
  2. candidate distances: the query set is replicated once up front, so the
     *owner* of each candidate row computes the distance locally and only a
     float per candidate crosses the interconnect — vectors never move (d x
     less traffic than shipping rows, the moral equivalent of the reference
     keeping computation on CNs but data on MNs, inverted here because
     FLOPs are cheap and interconnect bandwidth is not).

Upper layers are replicated on every device (they are ~N/(M-1) rows under the
geometric level draw, hnsw.hh:309-321) so greedy descent
(hnsw.hh:331-393) runs with zero communication — the analogue of the
reference's hot-vertex cache holding the upper layers (SURVEY.md §7.1).

Global node ids are plain rows; owner shard = id // rows_per_shard,
mirroring the reference RemotePtr's (16-bit MN | 48-bit offset) split
(src/remote_pointer.hh:7-29).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from shine_tpu.config import METRIC_L2, SearchParams
from shine_tpu.graph.soa import GraphSoA
from shine_tpu.ops.beam import (
    beam_frontier_multi,
    beam_init,
    beam_mark_expanded,
    beam_merge,
)
from shine_tpu.ops.distance import DIST_PRECISION, l2_rows, squared_norms
from shine_tpu.parallel.mesh import SHARD_AXIS


class ShardedGraph(NamedTuple):
    """Device-resident sharded index (a pytree).

    Sharded over the mesh (leading dim = global row, row-sharded):
      vectors (N', d), neighbors0 (N', 2M)
    Replicated upper-layer structure (u-indices are rows of this table):
      upper_ids (U,) global id of each upper node, -1 pad
      upper_vecs (U, d), upper_sqnorms (U,)
      upper_adj (U, L, M)*u-indices* (not global ids), -1 pad
      entry_u () u-index of the entry point
    """

    vectors: jnp.ndarray
    neighbors0: jnp.ndarray
    upper_ids: jnp.ndarray
    upper_vecs: jnp.ndarray
    upper_sqnorms: jnp.ndarray
    upper_adj: jnp.ndarray
    entry_u: jnp.ndarray

    @property
    def n_padded(self) -> int:
        return self.vectors.shape[0]

    @property
    def top_level(self) -> int:
        return self.upper_adj.shape[1]


def _pad_rows(a: np.ndarray, n_to: int, fill) -> np.ndarray:
    if a.shape[0] == n_to:
        return a
    pad = np.full((n_to - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def build_upper_tables(graph: GraphSoA) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(upper_ids (U,), upper_adj (U, L, M) in u-indices, entry_u).

    Rebases the upper-layer adjacency from global ids onto the compact
    upper-node table so descent never touches the sharded arrays.
    """
    upper_ids = np.where(graph.levels >= 1)[0].astype(np.int32)
    u_of_global = np.full(graph.n, -1, dtype=np.int32)
    u_of_global[upper_ids] = np.arange(len(upper_ids), dtype=np.int32)
    rows = graph.upper_row[upper_ids]  # rows into upper_neighbors
    adj_global = graph.upper_neighbors[rows]  # (U, L, M) global ids
    adj_u = np.where(
        adj_global >= 0, u_of_global[np.clip(adj_global, 0, graph.n - 1)], -1
    ).astype(np.int32)
    entry_u = u_of_global[graph.entry_point]
    assert entry_u >= 0
    return upper_ids, adj_u, entry_u


def shard_graph(
    graph: GraphSoA, mesh: Mesh, *, rows: str = "f32"
) -> ShardedGraph:
    """Pad to the shard grid and place arrays on the mesh.

    rows="bf16" stores the sharded layer-0 rows in bfloat16 (rounded
    like the single-device quantized path, models/hnsw.py:device_graph,
    so owned/replica/compact distances agree with it) — halves per-shard
    row bytes, which is
    what fits the 100M-class M=32 graph on a few devices. The replicated
    upper tables stay
    f32 (they are ~N/(M-1) rows; descent exactness is free). int8 rows
    are single-chip capacity-only: the per-gather dequant on the
    latency-critical traversal was a measured serving negative (~45%
    QPS, -1.7 pts eps-recall)."""
    S = mesh.devices.size
    n = graph.n
    per = -(-n // S)  # ceil
    n_pad = per * S
    host_v = np.asarray(graph.vectors, dtype=np.float32)
    if rows == "bf16":
        import ml_dtypes

        host_v = host_v.astype(ml_dtypes.bfloat16)
        vectors = _pad_rows(host_v, n_pad, 0.0)
    elif rows == "f32":
        vectors = _pad_rows(host_v, n_pad, 0.0)
    else:
        raise ValueError(
            f"sharded rows must be f32|bf16, got {rows!r} (int8 is "
            "single-chip capacity-only — see models/hnsw.py)"
        )
    nbrs0 = _pad_rows(graph.neighbors0, n_pad, -1)

    upper_ids, adj_u, entry_u = build_upper_tables(graph)
    upper_vecs = graph.vectors[upper_ids]
    upper_sq = (upper_vecs.astype(np.float32) ** 2).sum(axis=1)
    if graph.params.metric_id != METRIC_L2:
        upper_sq = np.zeros_like(upper_sq)

    row_sh = NamedSharding(mesh, P(SHARD_AXIS))
    rep = NamedSharding(mesh, P())
    dev = partial(jax.device_put)
    return ShardedGraph(
        vectors=dev(jnp.asarray(vectors), row_sh),
        neighbors0=dev(jnp.asarray(nbrs0), row_sh),
        upper_ids=dev(jnp.asarray(upper_ids), rep),
        upper_vecs=dev(jnp.asarray(upper_vecs, dtype=jnp.float32), rep),
        upper_sqnorms=dev(jnp.asarray(upper_sq, dtype=jnp.float32), rep),
        upper_adj=dev(jnp.asarray(adj_u), rep),
        entry_u=dev(jnp.asarray(entry_u, dtype=jnp.int32), rep),
    )


def _upper_descent(g: ShardedGraph, q, qn, metric: int) -> jnp.ndarray:
    """Greedy 1-NN walk down the replicated upper levels for a local query
    slice (B_loc, d). Returns the layer-0 entry id (global) per query.
    Zero communication (reference search_for_one, hnsw.hh:331-393)."""

    def dist_u(u_ids):  # (B, K) u-indices -> distances
        safe = jnp.maximum(u_ids, 0)
        vecs = g.upper_vecs[safe]
        dots = jnp.einsum(
            "bd,bkd->bk", q, vecs, precision=DIST_PRECISION,
            preferred_element_type=jnp.float32,
        )
        d = (
            1.0 - dots
            if metric != METRIC_L2
            else qn[:, None] - 2.0 * dots + g.upper_sqnorms[safe]
        )
        return jnp.where(u_ids >= 0, d, jnp.inf)

    B = q.shape[0]
    cur = jnp.broadcast_to(g.entry_u, (B,)).astype(jnp.int32)
    cur_d = dist_u(cur[:, None])[:, 0]
    top = g.upper_adj.shape[1]
    for level in range(top, 0, -1):

        def cond(state):
            return jnp.any(state[2])

        def body(state, level=level):
            cid, cdist, moved = state
            nbrs = g.upper_adj[jnp.maximum(cid, 0), level - 1]  # (B, M)
            nbrs = jnp.where(moved[:, None], nbrs, -1)
            d = dist_u(nbrs)
            j = jnp.argmin(d, axis=1)
            bd = jnp.take_along_axis(d, j[:, None], axis=1)[:, 0]
            bi = jnp.take_along_axis(nbrs, j[:, None], axis=1)[:, 0]
            # (dist, global id) lexicographic tie-break (heap.hh:53-57)
            bg = jnp.where(bi >= 0, g.upper_ids[jnp.maximum(bi, 0)], jnp.int32(2**31 - 1))
            cg = g.upper_ids[jnp.maximum(cid, 0)]
            better = ((bd < cdist) | ((bd == cdist) & (bg < cg))) & moved
            return (
                jnp.where(better, bi, cid),
                jnp.where(better, bd, cdist),
                better,
            )

        cur, cur_d, _ = jax.lax.while_loop(
            cond, body, (cur, cur_d, jnp.ones(B, jnp.bool_))
        )
    return g.upper_ids[cur]


def _owned_neighbor_rows(g: ShardedGraph, ids_all, rows_per_shard):
    """Shard-local: neighbor rows for the globally-gathered frontier ids
    this shard owns; zeros elsewhere (summed away by psum_scatter)."""
    my = jax.lax.axis_index(SHARD_AXIS)
    local = ids_all - my * rows_per_shard
    mine = (ids_all >= 0) & (local >= 0) & (local < rows_per_shard)
    rows = g.neighbors0[jnp.clip(local, 0, rows_per_shard - 1)]
    # -1 pad must not leak a bogus 0 through the sum: map not-mine -> 0,
    # and encode "no neighbor" as 0 contribution with a +1 bias
    return jnp.where(mine[..., None], rows + 1, 0)


def _owner_rpc(
    ids_flat,
    aux_flat,
    payload_fn,
    *,
    rows_per_shard: int,
    num_shards: int,
    bucket: int,
    width: int,
    dtype,
    fill,
):
    """Compact owner-compute RPC over bucketed `all_to_all`.

    The dense exchange pattern (all_gather ids -> every shard scans the
    full id set -> psum_scatter results) moves O(S*L) interconnect lanes per
    call. Here each id travels ONCE to its owning shard (id //
    rows_per_shard), the owner computes a (width,)-payload, and the
    payload travels once back: O(L) lanes. Ids in the self-bucket (the
    all_to_all diagonal) never cross the interconnect at all, so replica
    hits and affinity-routed batches directly reduce wire traffic — the
    analogue of the reference's doorbell-batched one-sided READs
    (rdma_reads.hh:9-38) where a CN pulls only the rows it needs.

    Fixed-shape buckets hold `bucket` lanes per (source, dest) pair;
    destinations that overflow are served in further rounds of the same
    exchange (exact — nothing is dropped), so the result is bit-identical
    to the dense path. Round count is bounded by ceil(max-dest-load /
    bucket); with the default 2x slack a second round is rare.

    ids_flat: (L,) global row ids, -1 = no work. aux_flat: (L,) int32
    side-channel delivered to payload_fn (e.g. the requesting query's
    local slot). payload_fn((S, bucket) ids, (S, bucket) aux) ->
    (S, bucket, width) computed at the owner; row i holds requests from
    source shard i. Returns (out (L, width), rounds, offdiag_lanes).
    """
    L = ids_flat.shape[0]
    my = jax.lax.axis_index(SHARD_AXIS)
    SCb = num_shards * bucket

    def cond(state):
        todo = (state[0] >= 0).any().astype(jnp.int32)
        return jax.lax.psum(todo, SHARD_AXIS) > 0

    def body(state):
        pending, out, rounds, lanes = state
        live = pending >= 0
        owner = jnp.where(live, pending // rows_per_shard, 0)
        onehot = (owner[:, None] == jnp.arange(num_shards)[None, :]) & live[:, None]
        rank = jnp.cumsum(onehot.astype(jnp.int32), axis=0) - 1
        rank = jnp.take_along_axis(rank, owner[:, None], axis=1)[:, 0]
        granted = live & (rank < bucket)
        slot = jnp.where(granted, owner * bucket + rank, SCb)  # SCb = drop
        send_ids = (
            jnp.full((SCb,), -1, jnp.int32)
            .at[slot]
            .set(jnp.where(granted, pending, -1), mode="drop")
        )
        send_aux = (
            jnp.zeros((SCb,), jnp.int32)
            .at[slot]
            .set(jnp.where(granted, aux_flat, 0), mode="drop")
        )
        recv_ids = jax.lax.all_to_all(
            send_ids.reshape(num_shards, bucket), SHARD_AXIS, 0, 0, tiled=True
        )
        recv_aux = jax.lax.all_to_all(
            send_aux.reshape(num_shards, bucket), SHARD_AXIS, 0, 0, tiled=True
        )
        payload = payload_fn(recv_ids, recv_aux)  # (S, bucket, width)
        back = jax.lax.all_to_all(payload, SHARD_AXIS, 0, 0, tiled=True)
        got = back.reshape(SCb, width)[jnp.clip(slot, 0, SCb - 1)]
        out = jnp.where(granted[:, None], got, out)
        lanes = lanes + (granted & (owner != my)).sum()
        return (jnp.where(granted, -1, pending), out, rounds + 1, lanes)

    init = (
        ids_flat.astype(jnp.int32),
        jnp.full((L, width), fill, dtype),
        jnp.int32(0),
        jnp.int32(0),
    )
    _, out, rounds, lanes = jax.lax.while_loop(cond, body, init)
    return out, rounds, lanes


def _rpc_bucket(lanes: int, num_shards: int, slack: float) -> int:
    """Fixed per-(source,dest) bucket capacity: expected uniform load
    (lanes / S) times a slack factor, floor 8, rounded up to 8."""
    want = int(lanes * slack / num_shards)
    return max(8, -(-want // 8) * 8)


def _owned_distances(g: ShardedGraph, q_all, ids_all, rows_per_shard, metric):
    """Shard-local distances for candidate ids this shard owns (0 elsewhere).

    q_all is the replicated full query batch; position b of ids_all belongs
    to query b, so the owner needs no extra routing information.
    """
    my = jax.lax.axis_index(SHARD_AXIS)
    local = ids_all - my * rows_per_shard
    mine = (ids_all >= 0) & (local >= 0) & (local < rows_per_shard)
    safe = jnp.clip(local, 0, rows_per_shard - 1)
    vecs = g.vectors[safe].astype(jnp.float32)  # (B, K, d); f32/bf16 rows
    if metric == METRIC_L2:
        d = l2_rows(q_all, vecs)  # the single-device traversal's form
    else:
        d = 1.0 - jnp.einsum(
            "bd,bkd->bk", q_all, vecs, precision=DIST_PRECISION,
            preferred_element_type=jnp.float32,
        )
    return jnp.where(mine, d, 0.0)


class _ShardState(NamedTuple):
    beam_d: jnp.ndarray
    beam_i: jnp.ndarray
    beam_e: jnp.ndarray
    step: jnp.ndarray
    hops: jnp.ndarray
    cache_hits: jnp.ndarray
    cache_misses: jnp.ndarray
    row_counts: jnp.ndarray  # (rows_per_shard,) owned-row accesses, or (1,)
    hot_counts: jnp.ndarray  # (H,) replica-hit accesses, or (1,)
    rpc_rounds: jnp.ndarray  # compact-exchange rounds (0 in dense mode)
    ici_lanes: jnp.ndarray  # off-diagonal RPC lanes actually occupied
    ici_bytes: jnp.ndarray  # per-chip wire bytes (fixed-shape payloads)


def _sharded_search_spmd(
    g: ShardedGraph,
    queries,  # (B_loc, d) local slice
    replica,  # HotReplica or None (static)
    *,
    sp: SearchParams,
    metric: int,
    rows_per_shard: int,
    num_shards: int,
    count_access: bool = False,
):
    """The shard_map body: every chip runs this over its query slice.

    With a hot-vertex replica (parallel/hot_cache.py), frontier
    neighborlists and candidate distances for replica-resident ids are
    served from local HBM: hit lanes are masked out of the owner-side
    gathers (the owners skip the HBM work) and filled locally after the
    exchange — the reference's cache_lookup short-circuit (hnsw.hh:524-548)
    in SPMD form. Collective payloads stay fixed-shape; hit counters feed
    cache statistics.
    """
    q = queries.astype(jnp.float32)
    B_loc = q.shape[0]
    compact = sp.exchange == "compact"
    qn = squared_norms(q) if metric == METRIC_L2 else jnp.zeros(B_loc, jnp.float32)

    # replicate the query batch once; per-step exchanges are then int32/f32
    # lanes only (see module docstring)
    q_all = jax.lax.all_gather(q, SHARD_AXIS).reshape(num_shards * B_loc, -1)

    E = sp.frontier
    beam = beam_init(B_loc, sp.ef)
    if sp.entry_mode == "dense":
        # dense entry over the replicated upper vertices — zero
        # communication, globally-best seeds (cf. models/hnsw.py)
        dots = jax.lax.dot_general(
            q, g.upper_vecs, (((1,), (1,)), ((), ())),
            precision=DIST_PRECISION, preferred_element_type=jnp.float32,
        )
        if metric == METRIC_L2:
            du = qn[:, None] - 2.0 * dots + g.upper_sqnorms[None, :]
        else:
            du = 1.0 - dots
        m = min(sp.entry_seeds, g.upper_ids.shape[0])
        _, sel = jax.lax.top_k(-du, m)
        seeds = g.upper_ids[sel]  # (B_loc, m) global ids
        # seed distances from the owners, in the beam's own form, so a
        # seed met again as a neighbour carries the same (dist, id)
        seeds_all = jax.lax.all_gather(seeds, SHARD_AXIS).reshape(-1, m)
        seed_d = jax.lax.psum_scatter(
            _owned_distances(g, q_all, seeds_all, rows_per_shard, metric),
            SHARD_AXIS,
            scatter_dimension=0,
            tiled=True,
        )
        beam = beam_merge(beam, seed_d, seeds)
    else:
        ep = _upper_descent(g, q, qn, metric)  # (B_loc,) global ids
        # entry distance via the owner-compute exchange
        ep_all = jax.lax.all_gather(ep, SHARD_AXIS).reshape(-1, 1)
        ep_d = jax.lax.psum_scatter(
            _owned_distances(g, q_all, ep_all, rows_per_shard, metric),
            SHARD_AXIS,
            scatter_dimension=0,
            tiled=True,
        )[:, 0]
        beam = beam_merge(beam, ep_d[:, None], ep[:, None])

    def cond(s: _ShardState):
        done = jnp.all(s.beam_e)
        all_done = jax.lax.psum(done.astype(jnp.int32), SHARD_AXIS)
        return (all_done < num_shards) & (s.step < sp.max_steps)

    def local_distances(ids, rows, hit):
        """Distances for replica-hit candidate lanes (B_loc, K)."""
        vecs = replica.hot_vecs[rows].astype(jnp.float32)
        if metric == METRIC_L2:
            d = l2_rows(q, vecs)  # the owners' form (_owned_distances)
        else:
            d = 1.0 - jnp.einsum(
                "bd,bkd->bk", q, vecs, precision=DIST_PRECISION,
                preferred_element_type=jnp.float32,
            )
        return jnp.where(hit & (ids >= 0), d, jnp.inf)

    def body(s: _ShardState):
        from shine_tpu.ops.beam import Beam

        beam = Beam(s.beam_d, s.beam_i, s.beam_e)
        slots, fids, active = beam_frontier_multi(beam, E)  # (B_loc, E)
        beam = beam_mark_expanded(beam, slots, active)

        if replica is not None:
            from shine_tpu.parallel.hot_cache import replica_lookup

            f_rows, f_hit = replica_lookup(replica, fids)
            fids_cold = jnp.where(f_hit, -1, fids)  # owners skip hit lanes
        else:
            fids_cold = fids

        rpc_rounds = jnp.int32(0)
        ici_lanes = jnp.int32(0)
        # f32 accumulator (int64 is unavailable without x64): ~1e-7
        # relative error at GB scale, fine for a wire-cost counter
        ici_bytes = jnp.float32(0)
        W = g.neighbors0.shape[1]

        # exchange 1: frontier neighborlists from the owning shards
        if compact:

            def nbr_payload(recv_ids, _aux):
                my = jax.lax.axis_index(SHARD_AXIS)
                local = recv_ids - my * rows_per_shard
                rows = g.neighbors0[jnp.clip(local, 0, rows_per_shard - 1)]
                return jnp.where(recv_ids[..., None] >= 0, rows, -1)

            bucket_f = _rpc_bucket(B_loc * E, num_shards, sp.exchange_slack)
            rows, r1, l1 = _owner_rpc(
                fids_cold.reshape(-1),
                jnp.zeros(B_loc * E, jnp.int32),
                nbr_payload,
                rows_per_shard=rows_per_shard,
                num_shards=num_shards,
                bucket=bucket_f,
                width=W,
                dtype=jnp.int32,
                fill=-1,
            )
            nbrs = rows.reshape(B_loc, E * W)
            rpc_rounds += r1
            ici_lanes += l1
            # off-diagonal payload per round: ids + aux out, W rows back
            ici_bytes += r1.astype(ici_bytes.dtype) * (
                (num_shards - 1) * bucket_f * (8 + 4 * W)
            )
        else:
            fid_all = jax.lax.all_gather(fids_cold, SHARD_AXIS).reshape(-1, E)
            nbr_rows = _owned_neighbor_rows(g, fid_all, rows_per_shard)  # (B, E, 2M)
            nbrs = (
                jax.lax.psum_scatter(
                    nbr_rows.reshape(fid_all.shape[0], -1),
                    SHARD_AXIS,
                    scatter_dimension=0,
                    tiled=True,
                )
                - 1
            )  # (B_loc, E*2M); undo +1 bias: 0 -> -1 (pad / inactive)
            # all_gather receives (S-1) peer slices; reduce-scatter ships
            # ~the full (S*B_loc, E*W) once per chip
            ici_bytes += jnp.float32(
                (num_shards - 1) * B_loc * E * 4
                + (num_shards - 1) * B_loc * E * W * 4
            )
        if replica is not None:
            local_nbrs = replica.hot_neighbors[f_rows]  # (B_loc, E, 2M)
            nbrs = jnp.where(
                f_hit[:, :, None],
                jnp.where(active[:, :, None], local_nbrs, -1),
                nbrs.reshape(B_loc, E, -1),
            ).reshape(B_loc, -1)
        cand = nbrs

        if replica is not None:
            c_rows, c_hit = replica_lookup(replica, cand)
            cand_cold = jnp.where(c_hit, -1, cand)
        else:
            c_hit = jnp.zeros_like(cand, dtype=jnp.bool_)
            cand_cold = cand

        # exchange 2: cold candidate distances computed at the owners
        K = cand_cold.shape[1]
        if compact:

            def dist_payload(recv_ids, recv_aux):
                my = jax.lax.axis_index(SHARD_AXIS)
                local = recv_ids - my * rows_per_shard
                safe = jnp.clip(local, 0, rows_per_shard - 1)
                src = jax.lax.broadcasted_iota(jnp.int32, recv_ids.shape, 0)
                qidx = src * B_loc + recv_aux  # slot into the replicated q_all
                qv = q_all[qidx]  # (S, bucket, d)
                rows = g.vectors[safe].astype(jnp.float32)
                if metric == METRIC_L2:
                    # sum of squared differences, as the dense path
                    dd = l2_rows(qv, rows[..., None, :])[..., 0]
                else:
                    dd = 1.0 - jnp.einsum(
                        "scd,scd->sc", qv, rows, precision=DIST_PRECISION,
                        preferred_element_type=jnp.float32,
                    )
                return jnp.where(recv_ids >= 0, dd, jnp.inf)[..., None]

            lane_q = jnp.arange(B_loc * K, dtype=jnp.int32) // K
            bucket_c = _rpc_bucket(B_loc * K, num_shards, sp.exchange_slack)
            d_rpc, r2, l2 = _owner_rpc(
                cand_cold.reshape(-1),
                lane_q,
                dist_payload,
                rows_per_shard=rows_per_shard,
                num_shards=num_shards,
                bucket=bucket_c,
                width=1,
                dtype=jnp.float32,
                fill=jnp.inf,
            )
            d = d_rpc.reshape(B_loc, K)
            rpc_rounds += r2
            ici_lanes += l2
            # ids + query-slot aux out, one f32 distance back
            ici_bytes += r2.astype(jnp.float32) * (
                (num_shards - 1) * bucket_c * 12
            )
            cand_all = None
            if count_access:  # counter-only gather (adaptation variant)
                cand_all = jax.lax.all_gather(cand_cold, SHARD_AXIS).reshape(
                    num_shards * B_loc, -1
                )
                # this gather is real interconnect traffic even though it only
                # feeds the access counters — count it so the compact-vs-
                # dense wire comparison stays honest under adaptive cache
                ici_bytes += jnp.float32((num_shards - 1) * B_loc * K * 4)
        else:
            cand_all = jax.lax.all_gather(cand_cold, SHARD_AXIS).reshape(
                num_shards * B_loc, -1
            )
            d_all = _owned_distances(
                g, q_all, cand_all, rows_per_shard, metric
            )
            d = jax.lax.psum_scatter(
                d_all, SHARD_AXIS, scatter_dimension=0, tiled=True
            )
            ici_bytes += jnp.float32(2 * (num_shards - 1) * B_loc * K * 4)
        d = jnp.where(cand_cold >= 0, d, jnp.inf)
        if replica is not None:
            d_local = local_distances(cand, c_rows, c_hit)
            d = jnp.where(c_hit, d_local, d)

        beam = beam_merge(beam, d, cand)
        hits = (c_hit & (cand >= 0)).sum(axis=1)
        misses = (cand_cold >= 0).sum(axis=1)

        row_counts, hot_counts = s.row_counts, s.hot_counts
        if count_access:
            # feed the cache adaptation loop (the reference admits during
            # queries, hnsw.hh:446-453; here owners count accesses to their
            # rows and the host refreshes the hot set between batches)
            my = jax.lax.axis_index(SHARD_AXIS)
            loc = cand_all - my * rows_per_shard
            mine = (cand_all >= 0) & (loc >= 0) & (loc < rows_per_shard)
            idx = jnp.where(mine, loc, rows_per_shard)
            row_counts = row_counts.at[idx.reshape(-1)].add(1.0, mode="drop")
            if replica is not None:
                hidx = jnp.where(
                    c_hit & (cand >= 0), c_rows, replica.capacity
                )
                hot_counts = hot_counts.at[hidx.reshape(-1)].add(
                    1.0, mode="drop"
                )
        return _ShardState(
            beam.dists, beam.ids, beam.expanded, s.step + 1,
            s.hops + active.sum(axis=1),
            s.cache_hits + hits, s.cache_misses + misses,
            row_counts, hot_counts,
            s.rpc_rounds + rpc_rounds, s.ici_lanes + ici_lanes,
            s.ici_bytes + ici_bytes,
        )

    H = replica.capacity if (count_access and replica is not None) else 1
    init = _ShardState(
        beam.dists,
        beam.ids,
        beam.expanded,
        jnp.int32(0),
        jnp.zeros(B_loc, jnp.int32),
        jnp.zeros(B_loc, jnp.int32),
        jnp.zeros(B_loc, jnp.int32),
        jnp.zeros(rows_per_shard if count_access else 1, jnp.float32),
        jnp.zeros(H, jnp.float32),
        jnp.int32(0),
        jnp.int32(0),
        jnp.float32(0),
    )
    out = jax.lax.while_loop(cond, body, init)
    return (
        out.beam_i[:, : sp.k],
        out.beam_d[:, : sp.k],
        out.hops,
        out.cache_hits,
        out.cache_misses,
        out.row_counts,
        jax.lax.psum(out.hot_counts, SHARD_AXIS),
        out.rpc_rounds,
        jax.lax.psum(out.ici_lanes, SHARD_AXIS),
        jax.lax.psum(out.ici_bytes, SHARD_AXIS),
    )


def make_sharded_search(
    mesh: Mesh, sp: SearchParams, metric: int, n_padded: int,
    with_cache: bool = False, with_counts: bool = False,
):
    """Build the jitted SPMD search for a given mesh/params (compiled once
    per (batch shape, params)). with_counts adds access-count outputs for
    the cache adaptation loop (a separate compiled variant so the static
    serving path pays nothing for them)."""
    from shine_tpu.parallel.hot_cache import HotReplica

    S = mesh.devices.size
    sp = sp.resolved()
    rows_per_shard = n_padded // S
    graph_spec = ShardedGraph(
        vectors=P(SHARD_AXIS),
        neighbors0=P(SHARD_AXIS),
        upper_ids=P(),
        upper_vecs=P(),
        upper_sqnorms=P(),
        upper_adj=P(),
        entry_u=P(),
    )
    # (ids, dists, hops, hits, misses) per-query-slice; row_counts are the
    # shard-owned rows (concatenated = global rows); hot_counts, rpc_rounds
    # and ici_lanes replicated (rounds are globally synchronized, lanes
    # psum'd)
    out_spec = (
        tuple(P(SHARD_AXIS) for _ in range(5))
        + (P(SHARD_AXIS), P(), P(), P(), P())
    )

    if with_cache:
        rep_spec = HotReplica(P(), P(), P())

        @jax.jit
        def run(g: ShardedGraph, queries: jnp.ndarray, replica: HotReplica):
            fn = jax.shard_map(
                lambda g_, q_, r_: _sharded_search_spmd(
                    g_, q_, r_, sp=sp, metric=metric,
                    rows_per_shard=rows_per_shard, num_shards=S,
                    count_access=with_counts,
                ),
                mesh=mesh,
                in_specs=(graph_spec, P(SHARD_AXIS), rep_spec),
                out_specs=out_spec,
                check_vma=False,
            )
            return fn(g, queries, replica)

        return run

    @jax.jit
    def run(g: ShardedGraph, queries: jnp.ndarray):
        fn = jax.shard_map(
            lambda g_, q_: _sharded_search_spmd(
                g_, q_, None, sp=sp, metric=metric,
                rows_per_shard=rows_per_shard, num_shards=S,
                count_access=with_counts,
            ),
            mesh=mesh,
            in_specs=(graph_spec, P(SHARD_AXIS)),
            out_specs=out_spec,
            check_vma=False,
        )
        return fn(g, queries)

    return run


class SlackController:
    """Measured-bytes probe over the compact-exchange bucket slack.

    The right bucket slack depends on workload skew, routing, and the
    replica hit rate — the static default (2.0) is measured-wrong under
    zipf skew + affinity routing (measured): occupancy
    wins only convert to wire bytes if the bucket shrinks. This ladder
    probes each level on one live batch (results are identical at any
    slack — overflow re-queues exactly), then serves at the level with
    the fewest measured wire bytes per batch; it re-probes periodically
    to track workload drift. Compiled-program count is bounded by the
    ladder size. Reference analogue: doorbell batches sized to the
    actual WR count (rdma-library/library/batched_read.hh:28-60).
    """

    LADDER = (1.0, 1.5, 2.0)

    def __init__(self, reprobe_every: int = 64):
        self.reprobe_every = reprobe_every
        self.samples: dict = {}
        self.batches = 0

    def pick(self) -> float:
        self.batches += 1
        if self.batches % self.reprobe_every == 0:
            self.samples = {}
        for lv in self.LADDER:
            if lv not in self.samples:
                return lv
        return min(self.samples, key=self.samples.get)

    def observe(self, level: float, nbytes: float) -> None:
        if level not in self.samples:
            self.samples[level] = nbytes


class ShardedIndex:
    """Multi-device index: host/native build + SPMD sharded search.

    The stand-in for the full CN+MN cluster (compute_node.cc +
    memory_node.hh): `mesh` plays the cluster, shards play MNs, query
    slices play CNs.
    """

    def __init__(
        self,
        graph: GraphSoA,
        mesh: Mesh,
        *,
        cache_capacity: int = 0,
        routing: bool = False,
        adaptive_cache: bool = False,
        refresh_every: int = 8,
        rows: str = "f32",
    ):
        self.graph = graph
        self.mesh = mesh
        self.rows = rows
        self.device = shard_graph(graph, mesh, rows=rows)
        self.metric = graph.params.metric_id
        self.replica = None
        self.access = None
        self.refresh_every = refresh_every
        self.refreshes = 0
        self._batches_seen = 0
        if cache_capacity:
            from shine_tpu.parallel.hot_cache import (
                AccessCounter,
                build_replica,
                select_hot_ids,
            )

            self.cache_capacity = min(cache_capacity, graph.n)
            rep = build_replica(
                graph, select_hot_ids(graph, cache_capacity), rows=rows
            )
            self._put_replica(rep)
            if adaptive_cache:
                # the cooling-table replacement (cache.hh:232-311): decayed
                # access counts accumulated on device, hot set re-ranked on
                # the host every refresh_every batches
                self.access = AccessCounter(graph.n)
        self.router = None
        self.routing_mode = routing if isinstance(routing, str) else (
            "static" if routing else None
        )
        if self.routing_mode:
            # affinity routing: permute each query batch so slice s holds
            # queries nearest shard s's region (query_router.hh analogue);
            # improves replica/local locality, never changes results.
            # "adaptive" carries per-slice load across batches and
            # recomputes quotas ∝ idleness (update_limits analogue).
            from shine_tpu.parallel.placement import Placement
            from shine_tpu.parallel.router import QueryRouter

            self._placement = Placement(graph, mesh.devices.size)
            self._router_cls = QueryRouter
            self._adaptive_router = None
        self.cache_hits = 0
        self.cache_misses = 0
        self.rpc_rounds = 0  # compact-exchange rounds (0 on the dense path)
        self.ici_lanes = 0  # off-diagonal RPC lanes actually shipped
        self.ici_bytes = 0.0  # cluster wire bytes (both exchange modes)
        self._slack_ctl: SlackController | None = None
        self._runs: dict = {}

    def _put_replica(self, rep) -> None:
        reps = NamedSharding(self.mesh, P())
        self.replica = jax.tree.map(lambda a: jax.device_put(a, reps), rep)

    def _absorb_counts(self, row_counts, hot_counts) -> None:
        """Fold one batch's device-side access counts into the decayed
        host counter; refresh the replica when due. Refreshing only swaps
        replica *contents* (same shapes), so no recompilation happens and
        search results are unchanged — hits serve the same rows the owner
        exchange would."""
        hot_ids = np.asarray(self.replica.hot_ids)
        self.access.absorb(
            np.asarray(row_counts), hot_ids, np.asarray(hot_counts)
        )
        self._batches_seen += 1
        if self._batches_seen % self.refresh_every == 0:
            self.refresh_cache()

    def refresh_cache(self) -> None:
        """Re-rank the hot set from the decayed counters and swap the
        replica (the reference's warmup/admission steady state,
        compute_node.cc:116-131)."""
        if self.access is None:
            return
        self._put_replica(
            self.access.refresh(
                self.graph, self.cache_capacity, rows=self.rows
            )
        )
        self.refreshes += 1

    def warm(self, queries: np.ndarray, search_params=None, *,
             batch_size: int = 4096) -> None:
        """Warmup pass: run the workload to heat the access counters, then
        refresh so the timed run starts with an adapted hot set; counters
        reset afterwards like the reference's post-warmup reset
        (compute_node.cc:116-131)."""
        self.search(queries, search_params, batch_size=batch_size)
        self.refresh_cache()
        self.cache_hits = 0
        self.cache_misses = 0

    def _get_run(self, sp: SearchParams, batch_size: int):
        adaptive = self.access is not None
        key = (sp, batch_size, adaptive)
        if key not in self._runs:
            self._runs[key] = make_sharded_search(
                self.mesh, sp, self.metric, self.device.n_padded,
                with_cache=self.replica is not None,
                with_counts=adaptive,
            )
        return self._runs[key]

    def _dispatch_batch(self, run, sp, batch_size: int, chunk, qsh):
        """One batch; when the slack ladder is active (run is None), pick
        the bucket slack for this batch and feed the measured wire bytes
        back to the controller."""
        if run is not None:
            return self._run_batch(run, chunk, qsh)
        import dataclasses as _dc

        lv = self._slack_ctl.pick()
        spb = _dc.replace(sp, exchange_slack=lv)
        b0 = self.ici_bytes
        out = self._run_batch(self._get_run(spb, batch_size), chunk, qsh)
        self._slack_ctl.observe(lv, self.ici_bytes - b0)
        return out

    def _run_batch(self, run, chunk: np.ndarray, qsh):
        """One fixed-shape batch on the mesh; folds cache counters and the
        adaptation loop. Returns (ids, dists, hops) as numpy."""
        qdev = jax.device_put(jnp.asarray(chunk), qsh)
        if self.replica is not None:
            ids, dd, hops, hits, misses, rc, hc, rr, il, ib = run(
                self.device, qdev, self.replica
            )
            self.cache_hits += int(np.asarray(hits).sum())
            self.cache_misses += int(np.asarray(misses).sum())
            if self.access is not None:
                self._absorb_counts(rc, hc)
        else:
            ids, dd, hops, _, _, _, _, rr, il, ib = run(self.device, qdev)
        self.rpc_rounds += int(np.asarray(rr))
        self.ici_lanes += int(np.asarray(il))
        self.ici_bytes += float(np.asarray(ib))
        hops = np.asarray(hops)
        # expansion counter for Statistics (ThreadStatistics analogue)
        self.last_hops = getattr(self, "last_hops", 0) + int(hops.sum())
        return np.asarray(ids), np.asarray(dd), hops

    def search(
        self,
        queries: np.ndarray,
        search_params: SearchParams | None = None,
        *,
        batch_size: int = 4096,
    ) -> tuple[np.ndarray, np.ndarray]:
        sp = (search_params or SearchParams()).resolved()
        S = self.mesh.devices.size
        batch_size = -(-batch_size // S) * S
        nq, d = queries.shape
        self.last_hops = 0  # per-call, like HNSWIndex.search
        ladder = sp.exchange == "compact" and sp.adaptive_slack
        if ladder and self._slack_ctl is None:
            self._slack_ctl = SlackController()
        run = None if ladder else self._get_run(sp, batch_size)
        qsh = NamedSharding(self.mesh, P(SHARD_AXIS))

        if self.routing_mode == "adaptive":
            return self._search_adaptive(
                queries, sp, run, qsh, batch_size
            )

        perm = None
        if self.routing_mode == "static":
            router = self._router_cls(self._placement, batch_size=batch_size)
            perm, _ = router.plan(queries)
            queries, _ = router.apply(queries, perm)
        nq_eff = len(queries)
        out_i = np.empty((nq_eff, sp.k), dtype=np.int32)
        out_d = np.empty((nq_eff, sp.k), dtype=np.float32)
        for lo in range(0, nq_eff, batch_size):
            hi = min(lo + batch_size, nq_eff)
            chunk = queries[lo:hi].astype(np.float32)
            if hi - lo < batch_size:
                chunk = np.concatenate(
                    [chunk, np.zeros((batch_size - (hi - lo), d), np.float32)]
                )
            ids, dd, _ = self._dispatch_batch(run, sp, batch_size, chunk, qsh)
            out_i[lo:hi] = ids[: hi - lo]
            out_d[lo:hi] = dd[: hi - lo]
        if perm is not None:
            from shine_tpu.parallel.router import QueryRouter

            out_i = QueryRouter.unpermute(out_i, perm, nq)
            out_d = QueryRouter.unpermute(out_d, perm, nq)
        return out_i, out_d

    def _search_adaptive(self, queries, sp, run, qsh, batch_size):
        """Batch-at-a-time serving with cross-batch quota feedback
        (query_router.hh:106-151,315-316): observe each served batch's
        per-slice hops, recompute the next batch's affine quotas."""
        from shine_tpu.parallel.router import AdaptiveQueryRouter, QueryRouter

        nq = queries.shape[0]
        ar = self._adaptive_router
        if ar is None or ar.batch_size != batch_size:
            ar = AdaptiveQueryRouter(self._placement, batch_size=batch_size)
            self._adaptive_router = ar
        ar.start(queries)
        perm_parts, id_parts, d_parts = [], [], []
        while (pb := ar.next_batch()) is not None:
            routed, valid = QueryRouter.apply(queries, pb)
            ids, dd, hops = self._dispatch_batch(
                run, sp, batch_size, routed, qsh
            )
            ar.observe(np.where(valid, hops, 0))
            perm_parts.append(pb)
            id_parts.append(ids)
            d_parts.append(dd)
        perm = np.concatenate(perm_parts)
        out_i = QueryRouter.unpermute(np.concatenate(id_parts), perm, nq)
        out_d = QueryRouter.unpermute(np.concatenate(d_parts), perm, nq)
        return out_i, out_d
