"""Cluster-sharded routed capacity serving: the multi-chip
RoutedSplitIndex (models/routed_split.py).

Clusters are dealt round-robin across the mesh (cluster c -> shard
c % S, local slot c // S — the owned-lane scheme of
parallel/ivf_sharded.py), each shard holds its (C/S + 1)*cap slice of
the cluster-major split tables (own PAD cluster last), and a search
batch runs SPMD:

  1. stage-1 probes + affinity sort + the rank-major column grant are
     computed identically on every shard (replicated queries/centroids,
     deterministic ops) — no exchange;
  2. each shard COMPACTS the granted columns to its owned lanes
     (stable sort keeps the rank-major priority order) and scans only
     those with the routed class-max kernel — P_loc ~ P/S lanes per
     shard instead of P, the S-fold work split;
  3. per-shard survivors carry GLOBAL row ids; one all_gather of the
     (B, kk) id lanes is the entire inter-chip traffic, and the exact
     regen re-rank of the S*kk union runs replicated.

Per-shard class-max states see only owned-cluster rows, so collision
loss is at most the single-chip kernel's; the gathered union is a
superset of any single shard's survivors. Lane overflow (a group
granted more owned columns than P_loc) is counted in last_overflow —
size shared_local against it; dropped columns degrade coverage
gracefully (lowest-priority first), never correctness.

Reference parity: the reference spreads its 100M envelope over 3-5
memory nodes and CNs READ only needed rows (memory_node.hh:112-125,
rdma_reads.hh:101-134); here the granted-column compaction plays the
owned-READ role and the id all_gather replaces the result RPC.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from shine_tpu.parallel.mesh import SHARD_AXIS

P_ = jax.sharding.PartitionSpec


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


class ShardedRoutedSplitIndex:
    """Cluster-sharded routed split serving. Build a single-chip
    RoutedSplitIndex (models/routed_split.py:build_routed_split with
    C % S == 0 via shards=) and wrap it with `from_single`."""

    def __init__(self, comp_sh, aux_sh, gid_sh, centroids, n, dim, metric,
                 mesh, *, C, cap, cls, row_source, base=None):
        self.comp = comp_sh  # (S*(C_loc+1)*cap, dpc) row-sharded
        self.aux_r = aux_sh  # (S*(C_loc+1), 2m, cls) sharded axis 0
        self.gid = gid_sh  # (S*(C_loc+1)*cap,) GLOBAL ids, row-sharded
        self.centroids = centroids  # replicated (C, d)
        self.n, self.dim, self.metric = n, dim, metric
        self.mesh = mesh
        self.C, self.cap, self.cls = C, cap, cls
        self.S = mesh.devices.size
        self.C_loc = C // self.S
        self.row_source = row_source
        self.base = base  # (vectors, sqnorms) replicated, host-base mode
        self.last_coverage = None
        self.last_overflow = None
        self.last_lanes = None
        self.last_fallback = 0
        self._runs: dict = {}

    @classmethod
    def from_single(klass, idx, mesh) -> "ShardedRoutedSplitIndex":
        """Re-deal a RoutedSplitIndex's cluster blocks round-robin onto
        the mesh. (At real scale per-shard tables would be ingested
        directly on their chips — this host re-layout is the
        CPU-mesh/test path; the SPMD search is the same either way.)"""
        assert idx.row_source is not None or idx.base_dev is not None, (
            "sharded routed serving re-ranks exactly: needs a row-keyed "
            "row_source (capacity mode, nothing resident) or the index's "
            "base_dev (host-base mode, replicated)"
        )
        S = mesh.devices.size
        C, cap, cls = idx.C, idx.cap, idx.cls
        assert C % S == 0, f"C={C} not divisible by mesh size {S}; " \
            "build with shards=S"
        C_loc = C // S
        dpc = idx.comp.shape[1]
        members = cap // cls
        n_pad = (C + 1) * cap  # idx tables may carry ingest-pad rows
        comp = np.asarray(idx.comp)[:n_pad].reshape(C + 1, cap, dpc)
        aux = np.asarray(idx.aux_r)  # (C+1, 2m, cls)
        gid = np.asarray(idx.gid)[:n_pad].reshape(C + 1, cap)
        own = np.arange(C).reshape(-1, S).T  # (S, C_loc): shard s owns s::S
        pad = C  # global pad cluster index
        comp_sh = np.concatenate(
            [np.concatenate([comp[own[s]], comp[pad:pad + 1]])
             for s in range(S)]
        ).reshape(S * (C_loc + 1) * cap, dpc)
        aux_sh = np.concatenate(
            [np.concatenate([aux[own[s]], aux[pad:pad + 1]])
             for s in range(S)]
        ).reshape(S * (C_loc + 1), 2 * members, cls)
        gid_sh = np.concatenate(
            [np.concatenate([gid[own[s]], gid[pad:pad + 1]])
             for s in range(S)]
        ).reshape(-1)
        from jax.sharding import NamedSharding

        row = NamedSharding(mesh, P_(SHARD_AXIS))
        ax0 = NamedSharding(mesh, P_(SHARD_AXIS, None, None))
        rep = NamedSharding(mesh, P_())
        return klass(
            jax.device_put(jnp.asarray(comp_sh), row),
            jax.device_put(jnp.asarray(aux_sh), ax0),
            jax.device_put(jnp.asarray(gid_sh), row),
            jax.device_put(idx.centroids, rep),
            idx.n, idx.dim, idx.metric, mesh,
            C=C, cap=cap, cls=cls, row_source=idx.row_source,
            base=(
                None if idx.row_source is not None
                else (
                    jax.device_put(
                        idx.base_dev.astype(jnp.float32), rep
                    ),
                    jax.device_put(idx.sqnorms, rep),
                )
            ),
        )

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        probes: int = 0,
        shared: int = 0,
        shared_local: int = 0,
        tile: int = 0,
        kk: int = 0,
        batch_size: int = 2048,
        fallback: float = 0.5,
    ) -> tuple[np.ndarray, np.ndarray]:
        """SPMD routed search; knobs mirror RoutedSplitIndex.search.
        shared_local: per-shard compacted lane count P_loc (default
        2*ceil(P/S)+2, capped at P). kk here is PER-SHARD survivors
        (default 4*k; the gathered union is S*kk). fallback > 0:
        queries whose SCANNED-wish fraction — granted AND kept within
        the owner's P_loc window, so owned-lane overflow drops count
        against it — falls below the threshold re-run SPMD in narrow
        T=16 tiles with a full grant and P_loc = P (no overflow): the
        single-chip spill guarantee, over the mesh, overflow included."""
        S = self.S
        from shine_tpu.models.routed_split import _auto_knobs, _auto_probes

        if probes <= 0:
            probes = _auto_probes(self.C)

        tile, shared = _auto_knobs(self.C, probes, tile, shared)
        probes = min(probes, self.C)
        if shared_local <= 0:
            shared_local = min(shared, 2 * (-(-shared // S)) + 2)
        if kk <= 0:
            # per-shard survivor width: the gathered union S*kk is
            # >= 2x the single-chip default 8*k for any S >= 2
            kk = 4 * k
        kk = min(kk, self.cls)
        nq, d = queries.shape
        batch_size = max(tile, _round_up(min(batch_size, max(nq, 1)), tile))
        nq_pad = _round_up(nq, batch_size)
        q_all = np.zeros((nq_pad, d), np.float32)
        q_all[:nq] = queries.astype(np.float32)
        from jax.sharding import NamedSharding

        q_dev = jax.device_put(
            jnp.asarray(q_all), NamedSharding(self.mesh, P_())
        )
        rerank = "regen" if self.row_source is not None else "base"
        r0, r1 = (
            self.row_source if self.row_source is not None else self.base
        )
        key = (k, probes, shared, shared_local, tile, kk, batch_size)
        if key not in self._runs:
            self._runs[key] = _make_routed_spmd(
                self.mesh, k, probes, shared, shared_local, tile, kk,
                self.metric, self.C, self.cap, self.cls, batch_size,
                rerank=rerank,
            )
        run = self._runs[key]
        parts = []
        for lo in range(0, nq_pad, batch_size):
            parts.append(run(
                self.comp, self.aux_r, self.gid, self.centroids,
                q_dev, jnp.int32(lo), r0, r1,
            ))
        out_d = np.asarray(jnp.concatenate([p[0] for p in parts]))[:nq]
        out_i = np.asarray(jnp.concatenate([p[1] for p in parts]))[:nq]
        self.last_coverage = float(np.mean(
            [np.asarray(p[2]) for p in parts]))
        self.last_overflow = int(np.sum([np.asarray(p[3]) for p in parts]))
        self.last_lanes = int(np.sum([np.asarray(p[5]) for p in parts]))
        self.last_fallback = 0
        if fallback > 0:
            g_all = np.concatenate(
                [np.asarray(p[4]) for p in parts]
            )[:nq]
            need = np.where(g_all < fallback)[0]
            self.last_fallback = int(len(need))
            if len(need):
                from shine_tpu.models.routed_split import _spill_plan

                out_i = out_i.copy()
                out_d = out_d.copy()
                Ts, Ps, bucket = _spill_plan(len(need), probes, self.C)
                qs = np.zeros((bucket, d), np.float32)
                qs[: len(need)] = queries[need].astype(np.float32)
                fkey = (k, probes, Ps, Ps, Ts, kk, bucket)
                if fkey not in self._runs:
                    self._runs[fkey] = _make_routed_spmd(
                        self.mesh, k, probes, Ps, Ps, Ts, kk,
                        self.metric, self.C, self.cap, self.cls,
                        bucket, rerank=rerank,
                    )
                fb = self._runs[fkey](
                    self.comp, self.aux_r, self.gid, self.centroids,
                    jax.device_put(
                        jnp.asarray(qs), NamedSharding(self.mesh, P_())
                    ),
                    jnp.int32(0), r0, r1,
                )
                out_i[need] = np.asarray(fb[1])[: len(need)]
                out_d[need] = np.asarray(fb[0])[: len(need)]
        return out_i, out_d

    def cost_counters(self, nq: int, k: int = 10, *, probes: int = 0,
                      shared: int = 0, shared_local: int = 0,
                      tile: int = 0) -> dict:
        """Analytic per-run cost (statistics.hh:122-141 analogue);
        probes/tile/shared <= 0 resolve with the same auto rules as
        search."""
        from shine_tpu.models.routed_split import _auto_knobs, _auto_probes

        S = self.S
        if probes <= 0:
            probes = _auto_probes(self.C)
        tile, shared = _auto_knobs(self.C, probes, tile, shared)
        if shared_local <= 0:
            shared_local = min(shared, 2 * (-(-shared // S)) + 2)
        kk = 4 * k
        groups = -(-nq // tile)
        row_bytes = self.comp.shape[1] * self.comp.dtype.itemsize + 12
        return {
            "distance_computations": nq * (self.C + shared * self.cap
                                           + S * kk),
            "scanned_rows": nq * min(shared, S * shared_local) * self.cap,
            "hbm_gather_bytes": groups * S * shared_local * self.cap
            * row_bytes,
            "ici_exchange_bytes": nq * kk * 4 * (S - 1)
            + nq * self.dim * 4 * (S - 1),
        }


def build_routed_split_sharded(
    n: int,
    dim: int,
    mesh,
    *,
    row_source,
    metric: str | int = "l2",
    cap_target: int = 4096,
    cls: int = 1024,
    cap_slack: float = 1.05,
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
    """Direct per-shard routed build: no single-chip table is ever
    materialized. Stages A-C (train / assignment / capacity order) are
    the deterministic single-chip plan (models/routed_split.py:
    _plan_routed) — so the per-shard tables are BIT-IDENTICAL to
    re-dealing a single-chip build (tests/test_routed_sharded.py) —
    and stage D runs as one shard_map: every shard streams ONLY its
    owned clusters' rows through the split packer (rows are pure
    functions of fold_in(key, global_id), io/device_synth.py), folding
    its share of the exact f32 ground truth, merged with one
    all_gather. Per-shard ingest wall is the single-chip wall / S.

    Returns ShardedRoutedSplitIndex, or (index, gt) when `queries` is
    given. Reference analogue: each MN populates only its own segment
    (memory_node.hh:112-125) while the plan (graph/placement) is built
    centrally."""
    from shine_tpu.config import metric_id
    from shine_tpu.models.routed_split import (
        NEG,
        _make_rowfn,
        _plan_routed,
    )
    from shine_tpu.ops.packing import (
        aux_routed_layout_chunk,
        comp_width,
        pack_split_device,
    )

    S = mesh.devices.size
    metric = metric_id(metric)
    say = log if log is not None else (lambda *_: None)
    rowfn = _make_rowfn(row_source, None, metric)
    dpc = comp_width(dim)
    int8 = comp_dtype == "int8"

    cents_dev, order, C, cap, rchunk = _plan_routed(
        n, dim, rowfn=rowfn, cap_target=cap_target, cls=cls,
        cap_slack=cap_slack, shards=S, train_size=train_size,
        kmeans_iters=kmeans_iters, seed=seed, achunk=achunk, say=say,
        assign_r=assign_r,
    )
    C_loc = C // S
    members = cap // cls
    n_loc = (C_loc + 1) * cap
    n_ing = _round_up(n_loc, rchunk)
    # re-deal the cluster-major order round-robin: shard s ingests
    # clusters s::S then the shared PAD cluster; -1 tail = ingest pad
    order3 = order.reshape(C + 1, cap)
    ord_sh = np.full((S, n_ing), -1, np.int32)
    for s in range(S):
        ord_sh[s, :n_loc] = np.concatenate(
            [order3[:C][s::S], order3[C:]]
        ).reshape(-1)

    from jax.sharding import NamedSharding

    ord_dev = jax.device_put(
        jnp.asarray(ord_sh), NamedSharding(mesh, P_(SHARD_AXIS, None))
    )
    # exact GT before the big tables exist, by the SAME streaming pass
    # the single-chip builder uses (fold_gt_stream) — bit-identical GT
    # between the two builders by construction, and the GT transients
    # never share device memory with the packed tables
    gt_i = None
    if queries is not None:
        from shine_tpu.models.routed_split import fold_gt_stream

        gt_i = fold_gt_stream(rowfn, n, queries, metric, gt_k=gt_k)
        say("# routed_split: exact ground truth folded (pre-ingest)")

    def spmd(ord_loc):
        ord1 = ord_loc[0]

        def body(_, c):
            gids = jax.lax.dynamic_slice(ord1, (c * rchunk,), (rchunk,))
            valid = gids >= 0
            x = rowfn(jnp.maximum(gids, 0))
            x = jnp.where(valid[:, None], x, 0.0)
            comp_c, aux_c = pack_split_device(
                x, metric=metric, dpc=dpc, int8=int8, rchunk=rchunk
            )
            aux_c = aux_c.at[0].set(jnp.where(valid, aux_c[0], NEG))
            # per-chunk cluster-block layout (same 100M-per-shard OOM
            # fix as build_routed_split: the flat (2, n_loc) aux plus
            # its transpose never coexist with the comp table)
            aux_b = aux_routed_layout_chunk(aux_c, cap, cls)
            return _, (comp_c, aux_b)

        _, (comp_s, aux_s) = jax.lax.scan(
            body, None, jnp.arange(n_ing // rchunk, dtype=jnp.int32)
        )
        # keep the n_ing pad rows: slicing to n_loc would double-buffer
        # the per-shard comp table (models/routed_split.py stage D)
        comp_s = comp_s.reshape(n_ing, dpc)
        aux_r = aux_s.reshape(n_ing // cap, 2 * members, cls)[: C_loc + 1]
        return comp_s, aux_r, ord1

    run = jax.jit(jax.shard_map(
        spmd,
        mesh=mesh,
        in_specs=(P_(SHARD_AXIS, None),),
        out_specs=(P_(SHARD_AXIS), P_(SHARD_AXIS, None, None),
                   P_(SHARD_AXIS)),
        check_vma=False,
    ))
    comp_sh, aux_sh, gid_sh = run(ord_dev)
    assert aux_sh.shape == (S * (C_loc + 1), 2 * members, cls)
    say("# routed_split: per-shard clustered tables packed")

    from jax.sharding import NamedSharding as _NS

    idx = ShardedRoutedSplitIndex(
        comp_sh, aux_sh, gid_sh,
        jax.device_put(cents_dev, _NS(mesh, P_())),
        n, dim, metric, mesh, C=C, cap=cap, cls=cls,
        row_source=row_source,
    )
    if queries is not None:
        return idx, gt_i
    return idx


def _make_routed_spmd(mesh, k, p, P, P_loc, T, kk, metric, C, cap, cls,
                      batch, rerank="regen"):
    from shine_tpu.ops.distance import (
        pairwise_distance,
        regen_rerank_topk,
        rerank_topk,
    )
    from shine_tpu.models.routed_split import _route_cols, scan_select

    S = mesh.devices.size
    C_loc = C // S
    B = batch
    G = B // T

    def spmd(comp, aux_r, gid, cents, q_dev, lo, r0, r1):
        # (r0, r1) = row_source (key, centers) for the exact regen
        # re-rank, or (vectors, sqnorms) replicated for host-base
        # indexes (the CLI route)
        q = jax.lax.dynamic_slice(q_dev, (lo, 0), (B, q_dev.shape[1]))
        q = q.astype(jnp.float32)
        # replicated stage-1 + routing: deterministic, no exchange
        scores1 = pairwise_distance(q, cents, metric)
        if C >= 4096 and p < C:
            _, probes_ = jax.lax.approx_max_k(
                -scores1, p, recall_target=0.999)
        else:
            _, probes_ = jax.lax.top_k(-scores1, p)
        if p > 1:
            perm = jnp.argsort(probes_[:, 1], stable=True)
            perm = perm[jnp.argsort(probes_[perm, 0], stable=True)]
        else:
            perm = jnp.argsort(probes_[:, 0], stable=True)
        inv = jnp.argsort(perm, stable=True)
        q_s = q[perm]
        pr_s = probes_[perm].reshape(G, T, p)
        cols, coverage, _ = _route_cols(pr_s, C, P)
        # compact to owned lanes (stable: rank-major priority kept)
        my = jax.lax.axis_index(SHARD_AXIS)
        owned = (cols < C) & (cols % S == my)
        lcol = jnp.where(owned, cols // S, C_loc)
        order = jnp.argsort(
            jnp.where(owned, 0, 1).astype(jnp.int32), axis=1, stable=True
        )
        lcol_c = jnp.take_along_axis(lcol, order, axis=1)[:, :P_loc]
        n_owned = owned.sum(axis=1)
        overflow = jnp.sum(jnp.maximum(n_owned - P_loc, 0))
        # measured scan width: owned lanes actually occupied (the rest
        # of the P_loc window points at the local PAD cluster)
        lanes_used = jnp.sum(jnp.minimum(n_owned, P_loc))
        # per-query SCANNED-wish fraction, not merely granted: a wish
        # counts iff its cluster survived the owner's P_loc window, so
        # overflow drops surface in the spill decision (each wish is
        # counted by exactly its owner; psum assembles the batch view)
        mine_w = (pr_s % S) == my
        hit = (
            (pr_s // S)[:, :, :, None] == lcol_c[:, None, None, :]
        ) & mine_w[:, :, :, None]
        q_scanned = jax.lax.psum(
            hit.any(-1).mean(-1).reshape(B), SHARD_AXIS
        )
        cand = scan_select(
            comp, aux_r, gid, q_s, lcol_c, C=C_loc, T=T, cap=cap, cls=cls,
            kk=kk,
        )
        # the whole inter-chip exchange: (S, B, kk) global-id lanes
        allc = jax.lax.all_gather(cand, SHARD_AXIS)
        allc = jnp.moveaxis(allc, 0, 1).reshape(B, S * kk)
        if rerank == "regen":
            d_out, i_out = regen_rerank_topk(r0, r1, q_s, allc, k, metric)
        else:
            d_out, i_out = rerank_topk(r0, r1, q_s, allc, k, metric)
        overflow = jax.lax.psum(overflow, SHARD_AXIS)
        lanes_used = jax.lax.psum(lanes_used, SHARD_AXIS)
        return (d_out[inv], i_out[inv], coverage, overflow,
                q_scanned[inv], lanes_used)

    @jax.jit
    def run(comp, aux_r, gid, cents, q_dev, lo, r0, r1):
        fn = jax.shard_map(
            spmd,
            mesh=mesh,
            in_specs=(P_(SHARD_AXIS), P_(SHARD_AXIS, None, None),
                      P_(SHARD_AXIS), P_(), P_(), P_(), P_(), P_()),
            out_specs=(P_(), P_(), P_(), P_(), P_(), P_()),
            check_vma=False,
        )
        return fn(comp, aux_r, gid, cents, q_dev, lo, r0, r1)

    return run
