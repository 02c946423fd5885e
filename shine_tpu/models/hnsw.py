"""Batched HNSW search on the accelerator.

The reference hides per-READ RDMA latency by interleaving coroutines
(reference src/hnsw/scheduler.hh); this design replaces latency
hiding with *batching*: B queries advance together through fixed-shape,
masked traversal steps under one `jax.jit`, so every neighbor expansion is a
single device-memory gather + distance tile instead of B pointer chases
(SURVEY.md §5.8).

Pipeline per query batch (reference knn, hnsw.hh:253-307):
  1. greedy descent through upper layers (search_for_one, hnsw.hh:331-393)
  2. ef-bounded best-first beam on layer 0 (search_level, hnsw.hh:406-476)
  3. top-k extraction
All loops are `lax.while_loop`s over fixed-shape state with per-query active
masks; a query that terminates early idles (masked) until the batch drains.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from shine_tpu.config import METRIC_L2, HNSWParams, SearchParams
from shine_tpu.graph.soa import GraphSoA
from shine_tpu.ops.beam import (
    Beam,
    beam_frontier_multi,
    beam_init,
    beam_mark_expanded,
    beam_merge,
)
from shine_tpu.ops.distance import DIST_PRECISION, l2_rows, squared_norms

# dense-entry sweep chunk: above this many upper vertices the one-shot
# (B, U) f32 tile is HBM-expensive (10M rows -> U=655k -> 5.4 GB, which
# OOMed the 10M graph's search program), so the entry stage streams
# U-chunks with a running top-m instead
ENTRY_UCHUNK = 131_072


class DeviceGraph(NamedTuple):
    """Device-resident SoA graph (a pytree — jit/shard_map friendly).

    Rows are stored at their natural width d (no fused norm column: the
    (8, 128) tile layout would pad d+1 to the next 128 lanes — a 2.0x
    HBM + gather-byte tax whenever d % 128 == 0). One traversal step is
    still a single row gather: the L2 norm term is recomputed from the
    gathered row inside the distance fusion (_dist_ext).

    Traversal is gather-BANDWIDTH-bound (removing a fused norm column
    halved row bytes and lifted 10M QPS ~1.5x), so rows may be
    stored quantized — selected at UPLOAD time, no rebuild:
      * f32  (default): 512 B/row at d=128, exact distances.
      * bf16: 256 B/row; distances are exact f32 distances to the
        bf16-rounded rows (~0.4% relative — the flat-scan noise class).
      * int8: 128 B/row + per-row (scale, norm) f32 in row_scl/row_nrm;
        distance = bias + <q_ext, row>*scl + nrm.
    The dense-entry sweep table (upper_vecs_ext) stays f32: it is
    matmul-swept, not gathered, and holds only ~N/M rows.
    """

    vectors_ext: jnp.ndarray  # (N, d) f32/bf16/int8 (see above)
    neighbors0: jnp.ndarray  # (N, 2M) i32
    upper_row: jnp.ndarray  # (N,) i32
    upper_neighbors: jnp.ndarray  # (U, L, M) i32
    entry_point: jnp.ndarray  # () i32
    upper_ids: jnp.ndarray  # (U,) i32 — global id of each upper vertex
    upper_vecs_ext: jnp.ndarray  # (U, d) f32 — dense entry stage
    row_scl: jnp.ndarray | None = None  # (N,) f32, int8 rows only
    row_nrm: jnp.ndarray | None = None  # (N,) f32 = ||v_q||^2, int8+L2

    @property
    def n(self) -> int:
        return self.vectors_ext.shape[0]


def _extend_query(
    q: jnp.ndarray, metric: int, width: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(q_ext (B, width), bias (B,)): dist = bias + q_ext . v [+ ||v||^2].

    Rows are stored unpadded (width = d): the norm term is computed from
    the gathered row itself (_dist_ext) — zero extra gathers and no
    norm column widening every row, a square-sum fused into the
    consumer."""
    B, d = q.shape
    pad = jnp.zeros((B, width - d), q.dtype)
    if metric == METRIC_L2:
        q_ext = jnp.concatenate([-2.0 * q, pad], axis=1)
        bias = jnp.sum(q * q, axis=-1)
    else:
        q_ext = jnp.concatenate([-q, pad], axis=1)
        bias = jnp.ones((B,), q.dtype)
    return q_ext, bias


def _pack_neighbors(nbr: np.ndarray) -> np.ndarray:
    """Pack 128//W neighbor lists per row when the list width W divides
    128. A (N, W<128) int32 table gathers through an XLA relayout that
    pads W up to the 128-lane tile AND copies: at 16.78M x 64 that is an
    8 GB HLO temp on top of the 4 GB argument — the stage-B serving OOM
    (chip_plan_r5g, 'copy.51 = copy(g_neighbors0)', 2.0x expansion).
    (N/p, 128) IS the natural (8, 128) tile: no pad, no copy, and the
    per-row gather reads the same one tile it always did. The beam step
    selects the W-slice by id % p with static slices + where
    (_beam_search_l0_seeded), keyed by the static nbr_width."""
    W = nbr.shape[1]
    p = 128 // W if (W < 128 and 128 % W == 0) else 1
    if p == 1:
        return nbr
    nbr = np.asarray(nbr)
    rows = -(-nbr.shape[0] // p)
    if rows * p != nbr.shape[0]:
        nbr = np.concatenate(
            [nbr, np.full((rows * p - nbr.shape[0], W), -1, nbr.dtype)]
        )
    return nbr.reshape(rows, p * W)


def device_graph(
    graph: GraphSoA, *, rows: str = "f32"
) -> tuple[DeviceGraph, int]:
    """Upload a host graph; returns (device pytree, static top_level).

    rows selects the traversal-row storage ("f32"|"bf16"|"int8" — see
    DeviceGraph; quantization happens here, so one built/checkpointed
    graph serves at any precision)."""
    upper_ids = np.where(graph.levels >= 1)[0].astype(np.int32)
    if len(upper_ids) == 0:
        upper_ids = np.array([graph.entry_point], dtype=np.int32)
    host_v = np.asarray(graph.vectors, dtype=np.float32)
    # dense-entry table: always f32, sliced host-side (U ~ N/M rows)
    upper_vecs = jnp.asarray(host_v[upper_ids])
    row_scl = row_nrm = None
    # quantization happens HOST-side so the upload moves 2-4x fewer
    # bytes and the device never holds an f32 temp (at 10M the f32 rows
    # alone are 5.4 GB)
    if rows == "bf16":
        import ml_dtypes

        vectors_ext = jnp.asarray(host_v.astype(ml_dtypes.bfloat16))
    elif rows == "int8":
        s = np.maximum(np.abs(host_v).max(axis=1), 1e-30)
        qv = np.clip(np.rint(host_v * (127.0 / s[:, None])), -127, 127)
        scl = (s / 127.0).astype(np.float32)
        row_scl = jnp.asarray(scl)
        row_nrm = jnp.asarray(
            ((qv * qv).sum(axis=1) * scl * scl).astype(np.float32)
        )
        vectors_ext = jnp.asarray(qv.astype(np.int8))
    elif rows == "f32":
        vectors_ext = jnp.asarray(host_v)
    else:
        raise ValueError(f"rows must be f32|bf16|int8, got {rows!r}")
    return (
        DeviceGraph(
            vectors_ext=vectors_ext,
            neighbors0=jnp.asarray(_pack_neighbors(graph.neighbors0)),
            upper_row=jnp.asarray(graph.upper_row),
            upper_neighbors=jnp.asarray(graph.upper_neighbors),
            entry_point=jnp.asarray(graph.entry_point, dtype=jnp.int32),
            upper_ids=jnp.asarray(upper_ids),
            upper_vecs_ext=upper_vecs,
            row_scl=row_scl,
            row_nrm=row_nrm,
        ),
        graph.top_level,
    )


def _dist_ext(
    g: DeviceGraph, q_ext: jnp.ndarray, bias: jnp.ndarray, ids: jnp.ndarray,
    l2: bool = True,
) -> jnp.ndarray:
    """(B, K) distances via one fused gather + reduce; inf where id<0.
    f32/bf16 rows under L2 take the sum of squared differences (l2_rows;
    q = -q_ext / 2 exactly); int8 rows and IP take the dot form."""
    safe = jnp.maximum(ids, 0)
    ve = g.vectors_ext[safe]  # (B, K, d) — f32/bf16/int8 (DeviceGraph)
    ve = ve.astype(jnp.float32)
    if l2 and g.row_scl is None:
        return jnp.where(ids >= 0, l2_rows(-0.5 * q_ext, ve), jnp.inf)
    dots = jnp.einsum(
        "bd,bkd->bk", q_ext, ve, precision=DIST_PRECISION,
        preferred_element_type=jnp.float32,
    )
    if g.row_scl is not None:  # int8 rows: dequant after the dot
        dots = dots * g.row_scl[safe]
        if l2:
            dots = dots + g.row_nrm[safe]
    return jnp.where(ids >= 0, bias[:, None] + dots, jnp.inf)


def _lex_better(d_new, i_new, d_old, i_old):
    """(dist, id) lexicographic improvement — the reference tie-break
    (heap.hh:53-57)."""
    return (d_new < d_old) | ((d_new == d_old) & (i_new < i_old))


def _greedy_descent(
    g: DeviceGraph,
    q_ext: jnp.ndarray,  # (B, d)
    bias: jnp.ndarray,  # (B,)
    cur_id: jnp.ndarray,  # (B,)
    cur_dist: jnp.ndarray,  # (B,)
    level: int,
    l2: bool = True,
):
    """Greedy 1-NN walk on one upper level for the whole batch.
    Returns (id, dist, distance_computations) per query."""

    def cond(state):
        moved = state[2]
        return jnp.any(moved)

    def body(state):
        cid, cdist, moved, dc = state
        rows = jnp.maximum(g.upper_row[jnp.maximum(cid, 0)], 0)
        nbrs = g.upper_neighbors[rows, level - 1]  # (B, M)
        nbrs = jnp.where(moved[:, None], nbrs, -1)  # idle queries gather nothing
        d = _dist_ext(g, q_ext, bias, nbrs, l2=l2)
        j = jnp.argmin(d, axis=1)
        bd = jnp.take_along_axis(d, j[:, None], axis=1)[:, 0]
        bi = jnp.take_along_axis(nbrs, j[:, None], axis=1)[:, 0]
        better = _lex_better(bd, bi, cdist, cid) & moved
        return (
            jnp.where(better, bi, cid),
            jnp.where(better, bd, cdist),
            better,
            dc + (nbrs >= 0).sum(axis=1),
        )

    init = (
        cur_id, cur_dist, jnp.ones_like(cur_id, dtype=jnp.bool_),
        jnp.zeros_like(cur_id),
    )
    cid, cdist, _, dc = jax.lax.while_loop(cond, body, init)
    return cid, cdist, dc


class _BeamState(NamedTuple):
    beam: Beam
    step: jnp.ndarray
    hops: jnp.ndarray  # (B,) expansions per query
    dists: jnp.ndarray  # (B,) EXACT distance computations (valid candidate
    # lanes actually scored — the reference's per-computation counter,
    # statistics.hh:152-158; hops * M_max0 overcounts masked/dedup lanes)


def _beam_search_l0(
    g: DeviceGraph,
    q_ext: jnp.ndarray,  # (B, d)
    bias: jnp.ndarray,  # (B,)
    ep_id: jnp.ndarray,  # (B,)
    ep_dist: jnp.ndarray,  # (B,)
    sp: SearchParams,
    l2: bool = True,
    nbr_width: int = 0,
):
    return _beam_search_l0_seeded(
        g, q_ext, bias, ep_id[:, None], ep_dist[:, None], sp, l2=l2,
        nbr_width=nbr_width,
    )


def _beam_search_l0_seeded(
    g: DeviceGraph,
    q_ext: jnp.ndarray,  # (B, d)
    bias: jnp.ndarray,  # (B,)
    seed_ids: jnp.ndarray,  # (B, m)
    seed_d: jnp.ndarray,  # (B, m)
    sp: SearchParams,
    l2: bool = True,
    nbr_width: int = 0,  # true list width W when neighbors0 is packed
) -> tuple[Beam, jnp.ndarray]:
    B = q_ext.shape[0]
    E = sp.frontier
    beam = beam_init(B, sp.ef)
    beam = beam_merge(beam, seed_d, seed_ids)

    def cond(s: _BeamState):
        if sp.term == "k":
            # the beam is (dist, id)-sorted, so an expanded top-k prefix
            # means no unexpanded entry is nearer than the k-th result —
            # the query's top-k is settled (queries whose ef tail is
            # still unexpanded keep improving others in lockstep until
            # every query settles)
            done = jnp.all(s.beam.expanded[:, : sp.k], axis=1)
        else:
            done = jnp.all(s.beam.expanded, axis=1)
        return (~jnp.all(done)) & (s.step < sp.max_steps)

    def body(s: _BeamState):
        slots, fids, active = beam_frontier_multi(s.beam, E)
        beam = beam_mark_expanded(s.beam, slots, active)
        safe = jnp.maximum(fids, 0)
        Wp = g.neighbors0.shape[1]
        if nbr_width and nbr_width < Wp:
            # packed table (_pack_neighbors): one (8,128)-tile row holds
            # p = Wp/W lists; gather the tile row, pick the W-slice by
            # id % p (static slices + where — fused, no extra gather)
            p = Wp // nbr_width
            block = g.neighbors0[safe // p]  # (B, E, p*W)
            nbrs = block[..., :nbr_width]
            for i in range(1, p):
                nbrs = jnp.where(
                    (safe % p == i)[:, :, None],
                    block[..., i * nbr_width:(i + 1) * nbr_width],
                    nbrs,
                )
        else:
            nbrs = g.neighbors0[safe]  # (B, E, 2M)
        nbrs = jnp.where(active[:, :, None], nbrs, -1).reshape(B, -1)
        d = _dist_ext(g, q_ext, bias, nbrs, l2=l2)
        beam = beam_merge(beam, d, nbrs)
        return _BeamState(
            beam, s.step + 1, s.hops + active.sum(axis=1),
            s.dists + (nbrs >= 0).sum(axis=1),
        )

    init = _BeamState(
        beam, jnp.int32(0), jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32)
    )
    out = jax.lax.while_loop(cond, body, init)
    return out.beam, out.hops, out.dists


@partial(
    jax.jit,
    static_argnames=(
        "top_level", "search_params", "metric", "with_stats", "nbr_width"
    ),
)
def batched_search(
    g: DeviceGraph,
    queries: jnp.ndarray,  # (B, d)
    *,
    top_level: int,
    search_params: SearchParams,
    metric: int = METRIC_L2,
    with_stats: bool = False,
    nbr_width: int = 0,  # true layer-0 list width when packed (HNSWIndex
    # passes it; 0 = unpacked legacy table)
):
    """k-NN for a batch of queries. Returns (ids (B,k), dists (B,k)[, hops])."""
    sp = search_params.resolved()
    q = queries.astype(jnp.float32)
    B = q.shape[0]
    q_ext, bias = _extend_query(q, metric, g.vectors_ext.shape[1])
    l2 = metric == METRIC_L2
    if sp.entry_mode == "dense":
        # dense entry: a (B, U) matmul sweep over the upper-level vertices
        # finds the *globally* nearest entry — a strictly better seed than
        # the reference's greedy descent (which can stop at a local
        # optimum), at negligible matmul cost (U ~ N/M rows). The descent
        # loops (and their per-iteration overhead) disappear entirely.
        # Above ~128k upper vertices the one-shot (B, U) f32 tile is
        # HBM-expensive (10M rows -> U=655k -> 5.4 GB; it OOMed the 10M
        # graph), so the sweep streams U-chunks with a running top-m.
        U = g.upper_ids.shape[0]
        m = min(sp.entry_seeds, U)
        UCHUNK = ENTRY_UCHUNK
        if U <= UCHUNK:
            dots = jax.lax.dot_general(
                q_ext, g.upper_vecs_ext, (((1,), (1,)), ((), ())),
                precision=DIST_PRECISION, preferred_element_type=jnp.float32,
            )  # (B, U)
            du = bias[:, None] + dots
            if l2:
                du = du + squared_norms(g.upper_vecs_ext)[None, :]
            nd, sel = jax.lax.top_k(-du, m)
            seed_ids = g.upper_ids[sel]  # (B, m)
        else:
            num_c = -(-U // UCHUNK)

            def entry_chunk(c, carry):
                bd, bi = carry
                lo = c * UCHUNK
                blk = jax.lax.dynamic_slice_in_dim(
                    g.upper_vecs_ext, jnp.minimum(lo, U - UCHUNK), UCHUNK, 0
                )
                off = jnp.minimum(lo, U - UCHUNK)
                dots = jax.lax.dot_general(
                    q_ext, blk, (((1,), (1,)), ((), ())),
                    precision=DIST_PRECISION,
                    preferred_element_type=jnp.float32,
                )
                du = bias[:, None] + dots
                if l2:
                    du = du + squared_norms(blk)[None, :]
                idx = off + jax.lax.broadcasted_iota(
                    jnp.int32, (B, UCHUNK), 1
                )
                # the clamped tail window (off < lo) re-covers ids already
                # seen by earlier chunks; an unmasked duplicate that lands
                # in the running top-m would DISPLACE a genuine m-th seed
                # (the beam dedups ids, so the chunked path would start
                # with fewer unique seeds than the one-shot sweep — a
                # real, graph-dependent results divergence, caught as an
                # order-dependent test flake)
                du = jnp.where(idx >= lo, du, jnp.inf)
                all_d = jnp.concatenate([bd, du], axis=1)
                all_i = jnp.concatenate([bi, idx], axis=1)
                nd_, sel_ = jax.lax.top_k(-all_d, m)
                return -nd_, jnp.take_along_axis(all_i, sel_, axis=1)

            bd0 = jnp.full((B, m), jnp.inf, jnp.float32)
            bi0 = jnp.zeros((B, m), jnp.int32)
            nd, sel = jax.lax.fori_loop(
                0, num_c, entry_chunk, (bd0, bi0)
            )
            seed_ids = g.upper_ids[sel]
        # seed distances in the beam's own form (_dist_ext), so a seed met
        # again as a neighbour carries the same (dist, id) and dedups
        seed_d = _dist_ext(g, q_ext, bias, seed_ids, l2=l2)
        beam, hops, dc = _beam_search_l0_seeded(
            g, q_ext, bias, seed_ids, seed_d, sp, l2=l2,
            nbr_width=nbr_width,
        )
        # the dense entry tile scores every upper vertex per query
        dc = dc + jnp.int32(g.upper_ids.shape[0])
    else:
        ep = jnp.broadcast_to(g.entry_point, (B,)).astype(jnp.int32)
        ep_dist = _dist_ext(g, q_ext, bias, ep[:, None], l2=l2)[:, 0]
        dc = jnp.ones(B, jnp.int32)  # the entry-point distance
        for level in range(top_level, 0, -1):
            ep, ep_dist, d_lvl = _greedy_descent(
                g, q_ext, bias, ep, ep_dist, level, l2=l2
            )
            dc = dc + d_lvl
        beam, hops, d_l0 = _beam_search_l0(
            g, q_ext, bias, ep, ep_dist, sp, l2=l2, nbr_width=nbr_width
        )
        dc = dc + d_l0
    ids = beam.ids[:, : sp.k]
    dists = beam.dists[:, : sp.k]
    if with_stats:
        return ids, dists, hops, dc
    return ids, dists


class HNSWIndex:
    """Single-chip index: host build (native C++) + device batched search.

    The flagship model of the framework — the stand-in for the
    reference's ComputeNode+HNSW pair in the one-CN configuration.
    """

    def __init__(self, graph: GraphSoA, *, rows: str = "f32"):
        self.graph = graph
        self.device, self.top_level = device_graph(graph, rows=rows)
        self.metric = graph.params.metric_id
        # true layer-0 list width (neighbors0 may be packed on device)
        self.nbr_width = int(graph.neighbors0.shape[1])

    @classmethod
    def build(
        cls, vectors: np.ndarray, params: HNSWParams | None = None, **kw
    ) -> "HNSWIndex":
        from shine_tpu.graph.soa import build_graph

        return cls(build_graph(vectors, params or HNSWParams(), **kw))

    def search(
        self,
        queries: np.ndarray,
        search_params: SearchParams | None = None,
        *,
        batch_size: int = 1024,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Search an arbitrary number of queries in fixed-size batches
        (padding the tail so only one program is compiled per batch size).

        Side effect: accumulates expansion counters into self.last_hops
        (the distcomp/visited counters of the reference ThreadStatistics,
        statistics.hh:148-175) when with_stats was requested at least once.
        """
        sp = (search_params or SearchParams()).resolved()
        nq, d = queries.shape
        out_i = np.empty((nq, sp.k), dtype=np.int32)
        out_d = np.empty((nq, sp.k), dtype=np.float32)
        self.last_hops = 0
        self.last_dists = 0  # exact distance computations (see _BeamState)
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            chunk = queries[lo:hi]
            if hi - lo < batch_size:
                pad = np.zeros((batch_size - (hi - lo), d), chunk.dtype)
                chunk = np.concatenate([chunk, pad], axis=0)
            ids, dd, hops, dc = batched_search(
                self.device,
                jnp.asarray(chunk),
                top_level=self.top_level,
                search_params=sp,
                metric=self.metric,
                with_stats=True,
                nbr_width=self.nbr_width,
            )
            out_i[lo:hi] = np.asarray(ids)[: hi - lo]
            out_d[lo:hi] = np.asarray(dd)[: hi - lo]
            self.last_hops += int(np.asarray(hops)[: hi - lo].sum())
            self.last_dists += int(np.asarray(dc)[: hi - lo].sum())
        return out_i, out_d
