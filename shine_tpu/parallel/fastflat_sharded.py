"""Multi-device FastFlat: the class-max scan over a row-sharded base.

Each device holds a row range of the packed score table (capacity scales
with devices), runs the class-max scan (ops/classmax.py) over its own
rows, selects its local top-kb candidates, re-ranks them *exactly* in
f32 against its own rows (owners hold the vectors), and one `all_gather`
of (B, kb) (dist, id) lanes merges the shards — the same tiny merge as
flat_sharded.py with the class-max scan underneath.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from shine_tpu.config import METRIC_L2, metric_id
from shine_tpu.ops.classmax import (
    classmax_scan,
    classmax_split,
    select_candidates,
)
from shine_tpu.ops.distance import rerank_topk
from shine_tpu.ops.packing import (
    SPLIT_QUANTUM,
    pack_ext_query,
    pack_ext_table,
    pack_split_query,
    pack_split_tables,
)
from shine_tpu.parallel.mesh import SHARD_AXIS


def _local_scan(ext, q, kb, cls, keep2):
    """Per-shard class-max scan -> (local candidate rows, their stage-1
    scores, K). The scores feed the FREE prerank trim
    (ops/distance.py:score_trim) — no table re-read."""
    q_ext = pack_ext_query(q, ext.shape[1]).astype(jnp.bfloat16)
    out = classmax_scan(ext, q_ext, cls=cls, keep2=keep2)
    cand, vals = select_candidates(out, kb, keep2)
    return cand, vals, min(kb, cls)


def _merge_shards(dd, gi, k):
    """all_gather the per-shard (B, kb) (dist, global id) lanes and take
    the global (dist, id)-ascending top-k — the whole inter-chip cost."""
    B = dd.shape[0]
    all_d = jax.lax.all_gather(dd, SHARD_AXIS)  # (S, B, kb)
    all_i = jax.lax.all_gather(gi, SHARD_AXIS)
    all_d = jnp.moveaxis(all_d, 0, 1).reshape(B, -1)
    all_i = jnp.moveaxis(all_i, 0, 1).reshape(B, -1)
    key_i = jnp.where(all_i < 0, jnp.int32(2**31 - 1), all_i)
    md, _, mi = jax.lax.sort((all_d, key_i, all_i), dimension=1, num_keys=2)
    return md[:, :k], mi[:, :k]


def _make_search(
    mesh: Mesh, k: int, kb: int, cls: int, metric: int,
    rows_per_shard: int, keep2: bool = False,
    prerank: int = 0,
):
    def spmd(ext, vectors, sqnorms, queries):
        q = queries.astype(jnp.float32)
        cand_local, vals, kb_eff = _local_scan(ext, q, kb, cls, keep2)
        cand_local = jnp.where(cand_local < vectors.shape[0], cand_local, -1)
        if prerank and k <= prerank < cand_local.shape[1]:
            # FREE stage-1 trim from the scan's own scores: shrinks BOTH
            # the exact-re-rank gather and the merge's all_gather lanes
            # (kb -> prerank per shard) at the cost of one (B, K) sort
            from shine_tpu.ops.distance import score_trim

            cand_local = score_trim(vals, cand_local, prerank)
            kb_eff = prerank
        # exact f32 re-rank against OWNED rows
        dd, ii = rerank_topk(vectors, sqnorms, q, cand_local, kb_eff, metric)
        my = jax.lax.axis_index(SHARD_AXIS)
        gi = jnp.where(ii >= 0, ii + my * rows_per_shard, -1)
        return _merge_shards(dd, gi, k)

    @jax.jit
    def run(ext, vectors, sqnorms, queries):
        fn = jax.shard_map(
            spmd,
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return fn(ext, vectors, sqnorms, queries)

    return run


def _make_search_ext(
    mesh: Mesh, k: int, kb: int, cls: int, metric: int,
    rows_per_shard: int, keep2: bool = False,
    with_regen: bool = False, prerank: int = 0,
):
    """Capacity-mode SPMD search: each shard holds ONLY its slice of the
    packed bf16 ext table (no f32 base anywhere — per-chip capacity is
    set by the 2-byte ext row alone). Re-rank is either bf16 ext rows
    (rerank_topk_ext) or, with a row-keyed source, EXACT f32 rows
    regenerated from the candidates' global ids in-jit
    (ops/distance.py:regen_rerank_topk). This is the configuration that
    scales to the reference's 100M-row envelope
    (/root/reference/src/memory_node.hh:112-125 — 44 GB/MN x 5 MN; here
    320 B/row at d=128, 100M rows over 4 devices = 8 GB each)."""
    from shine_tpu.ops.distance import regen_rerank_topk, rerank_topk_ext

    def spmd(ext, queries, *rs):
        q = queries.astype(jnp.float32)
        cand_local, vals, kb_eff = _local_scan(ext, q, kb, cls, keep2)
        cand_local = jnp.where(cand_local < ext.shape[0], cand_local, -1)
        my = jax.lax.axis_index(SHARD_AXIS)
        if with_regen:
            if prerank and k <= prerank < cand_local.shape[1]:
                # FREE trim before the O(candidates) threefry regen —
                # the trim reuses the scan's own scores (score_trim),
                # whose precision equals the stage that picked the
                # candidates, so the exact stage keeps its recall
                from shine_tpu.ops.distance import score_trim

                cand_local = score_trim(vals, cand_local, prerank)
                kb_eff = prerank
            rkey, centers = rs
            gid = jnp.where(
                cand_local >= 0, cand_local + my * rows_per_shard, -1
            )
            dd, gi = regen_rerank_topk(rkey, centers, q, gid, kb_eff, metric)
        else:
            dd, ii = rerank_topk_ext(ext, q, cand_local, kb_eff, metric)
            gi = jnp.where(ii >= 0, ii + my * rows_per_shard, -1)
        return _merge_shards(dd, gi, k)

    @jax.jit
    def run(ext, queries, *rs):
        fn = jax.shard_map(
            spmd,
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P()) + (P(),) * len(rs),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return fn(ext, queries, *rs)

    return run


def _make_search_split(
    mesh: Mesh, k: int, kb: int, cls: int, metric: int,
    rows_per_shard: int, keep2: bool = False,
    with_regen: bool = False, prerank: int = 0,
):
    """Capacity-mode SPMD search on the SPLIT layout: each shard holds
    its slice of the component table (bf16: 264 B/row, int8: 136 B/row
    at d=128) + the f32 aux pair — per-device capacity 2.4-4.7x the packed
    ext layout (the reference's whole-cluster envelope is 100M,
    memory_node.hh:112-125). Re-rank is split-table dequant or EXACT f32
    regen via row_source."""
    from shine_tpu.ops.distance import regen_rerank_topk, rerank_topk_split

    def spmd(comp, aux, queries, *rs):
        q = queries.astype(jnp.float32)
        out = classmax_split(
            comp, aux, pack_split_query(q, comp.shape[1]), cls=cls,
            keep2=keep2,
        )
        cand_local, vals = select_candidates(out, kb, keep2)
        kb_eff = min(kb, cls)
        cand_local = jnp.where(cand_local < comp.shape[0], cand_local, -1)
        my = jax.lax.axis_index(SHARD_AXIS)
        if with_regen:
            if prerank and k <= prerank < cand_local.shape[1]:
                # FREE stage-1 trim from the scan's own scores before
                # the exact regen re-rank (same win as _make_search_ext)
                from shine_tpu.ops.distance import score_trim

                cand_local = score_trim(vals, cand_local, prerank)
                kb_eff = prerank
            rkey, centers = rs
            gid = jnp.where(
                cand_local >= 0, cand_local + my * rows_per_shard, -1
            )
            dd, gi = regen_rerank_topk(rkey, centers, q, gid, kb_eff, metric)
        else:
            dd, ii = rerank_topk_split(comp, aux, q, cand_local, kb_eff,
                                       metric)
            gi = jnp.where(ii >= 0, ii + my * rows_per_shard, -1)
        return _merge_shards(dd, gi, k)

    @jax.jit
    def run(comp, aux, queries, *rs):
        fn = jax.shard_map(
            spmd,
            mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(None, SHARD_AXIS), P())
            + (P(),) * len(rs),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return fn(comp, aux, queries, *rs)

    return run


class ShardedSplitFlatIndex:
    """Row-sharded capacity-mode k-NN on the split layout — the
    100M-1B-class serving configuration (see _make_search_split)."""

    def __init__(
        self,
        comp_dev,
        aux_dev,
        n: int,
        mesh: Mesh,
        metric: str | int = "l2",
        *,
        dim: int | None = None,
        row_source=None,
    ):
        self.metric = metric_id(metric)
        self.mesh = mesh
        S = mesh.devices.size
        n_pad, dpc = comp_dev.shape
        assert n_pad % (SPLIT_QUANTUM * S) == 0 and n <= n_pad
        assert aux_dev.shape == (2, n_pad)
        row_sh = NamedSharding(mesh, P(SHARD_AXIS))
        aux_sh = NamedSharding(mesh, P(None, SHARD_AXIS))
        self.comp = jax.device_put(comp_dev, row_sh)
        self.aux = jax.device_put(aux_dev, aux_sh)
        self.n = n
        self.dim = dim if dim is not None else dpc
        self.rows = n_pad // S
        self.row_source = row_source
        self.perm = None  # from_host shuffle map: packed id -> original
        self._runs: dict = {}

    @classmethod
    def from_host(
        cls,
        vectors: np.ndarray,
        mesh: Mesh,
        metric: str | int = "l2",
        *,
        comp_dtype: str = "int8",
        shuffle: bool = True,
        seed: int = 0,
    ) -> "ShardedSplitFlatIndex":
        """Pack a HOST-resident base into row-sharded split tables — the
        CLI/file-ingest route to mesh capacity serving (the row-keyed
        datasets take from_dataset instead). shuffle decorrelates class
        membership from file order (the class-collision model assumes
        it); search output maps packed ids back through the stored perm.
        Re-rank runs from the split tables (near-exact); attach a
        row_source afterwards for the exact-regen path."""
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = v.shape
        perm = None
        if shuffle:
            rng = np.random.default_rng(seed)
            perm = rng.permutation(n).astype(np.int32)
            v = v[perm]
        S = mesh.devices.size
        quantum = SPLIT_QUANTUM * S
        n_pad = -(-n // quantum) * quantum
        comp, aux = pack_split_tables(
            v, metric_id(metric), n_pad,
            comp_dtype=np.int8 if comp_dtype == "int8" else np.float16,
        )
        comp_dev = jnp.asarray(comp) if comp_dtype == "int8" else (
            jnp.asarray(comp).astype(jnp.bfloat16)
        )
        self = cls(comp_dev, jnp.asarray(aux), n, mesh, metric, dim=d)
        self.perm = perm
        return self

    @classmethod
    def from_dataset(cls, ds, mesh: Mesh, **kw) -> "ShardedSplitFlatIndex":
        """From io/device_synth.device_rowkeyed_split_dataset (already
        mesh-sharded when built with mesh=...)."""
        return cls(
            ds.comp_dev, ds.aux_dev, ds.n, mesh, ds.metric,
            row_source=ds.row_source, **kw,
        )

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        kb: int = 32,
        batch_size: int = 4096,
        cls: int = 0,
        keep2: bool | None = None,
        prerank: int = 0,
    ) -> tuple[np.ndarray, np.ndarray]:
        from shine_tpu.models.flat import cls_auto, keep2_auto

        if cls <= 0:
            cls = cls_auto(self.rows)
        if keep2 is None:
            keep2 = keep2_auto(self.rows, cls)
        kb = max(kb, k)
        nq, d = queries.shape
        batch_size = min(batch_size, max(nq, 1))
        key = (k, kb, cls, batch_size, keep2, prerank)
        if key not in self._runs:
            self._runs[key] = _make_search_split(
                self.mesh, k, kb, cls, self.metric, self.rows,
                keep2=keep2, with_regen=self.row_source is not None,
                prerank=prerank,
            )
        run = self._runs[key]
        rep = NamedSharding(self.mesh, P())
        extra = tuple(self.row_source) if self.row_source is not None else ()
        out_i = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            q = queries[lo:hi].astype(np.float32)
            if hi - lo < batch_size:
                q = np.concatenate(
                    [q, np.zeros((batch_size - (hi - lo), d), np.float32)]
                )
            qd = jax.device_put(jnp.asarray(q), rep)
            dd, ii = run(self.comp, self.aux, qd, *extra)
            out_d[lo:hi] = np.asarray(dd)[: hi - lo]
            out_i[lo:hi] = np.asarray(ii)[: hi - lo]
        out_i = np.where(out_i < self.n, out_i, -1)
        if self.perm is not None:  # from_host shuffle: map back
            out_i = np.where(
                out_i >= 0, self.perm[np.maximum(out_i, 0)], -1
            )
        return out_i, out_d

    def cost_counters(self, nq: int, k: int = 10, *, kb: int = 32,
                      batch_size: int = 4096) -> dict:
        S = self.mesh.devices.size
        n_pad = int(self.comp.shape[0])
        batches = -(-nq // max(batch_size, 1))
        table = int(self.comp.nbytes) + int(self.aux.nbytes)
        return {
            "distance_computations": nq * n_pad + nq * kb * S,
            "scanned_rows": nq * n_pad,
            "hbm_gather_bytes": batches * table
            + nq * kb * S * self.dim * 4,
            "ici_exchange_bytes": nq * self.dim * 4 * (S - 1)
            + nq * kb * 8 * (S - 1),
        }


class ShardedFastFlatIndex:
    """Row-sharded exact-ish k-NN with the class-max scan."""

    def __init__(
        self,
        vectors: np.ndarray,
        mesh: Mesh,
        metric: str | int = "l2",
        *,
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.metric = metric_id(metric)
        self.mesh = mesh
        S = mesh.devices.size
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = v.shape
        self.perm = None
        if shuffle:
            rng = np.random.default_rng(seed)
            self.perm = rng.permutation(n).astype(np.int32)
            v = v[self.perm]
        quantum = 4096 * S
        n_pad = -(-n // quantum) * quantum
        ext = pack_ext_table(v, self.metric, n_pad)
        vpad = np.zeros((n_pad, d), np.float32)
        vpad[:n] = v
        sq = (vpad * vpad).sum(-1) if self.metric == METRIC_L2 else np.zeros(
            n_pad, np.float32
        )
        sq[n:] = np.inf
        row_sh = NamedSharding(mesh, P(SHARD_AXIS))
        self.ext = jax.device_put(jnp.asarray(ext, jnp.bfloat16), row_sh)
        self.vectors = jax.device_put(jnp.asarray(vpad), row_sh)
        self.sqnorms = jax.device_put(jnp.asarray(sq.astype(np.float32)), row_sh)
        self.n, self.dim = n, d
        self.rows = n_pad // S
        self.row_source = None
        self._runs: dict = {}

    @classmethod
    def from_ext(
        cls,
        ext_dev,
        n: int,
        mesh: Mesh,
        metric: str | int = "l2",
        *,
        dim: int | None = None,
        row_source=None,
    ) -> "ShardedFastFlatIndex":
        """Sharded CAPACITY mode: row-shard the packed bf16 score table
        over the mesh with NO per-shard f32 base — per-device rows are
        limited by the 2-byte ext row alone (d=128 -> 320 B/row, so four
        devices hold a 100M-row table, the reference's serving envelope,
        memory_node.hh:112-125). Re-rank per shard is
        bf16 ext rows, or EXACT f32 via row_source=(key, centers)
        regeneration (io/device_synth.py row-keyed datasets). Pair with
        device_rowkeyed_ext_dataset(mesh=...) for sharded streaming
        ingestion that never materializes the base."""
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        self.mesh = mesh
        S = mesh.devices.size
        n_pad, dp = ext_dev.shape
        assert n_pad % (4096 * S) == 0 and n <= n_pad
        row_sh = NamedSharding(mesh, P(SHARD_AXIS))
        self.ext = jax.device_put(ext_dev.astype(jnp.bfloat16), row_sh)
        self.vectors = None
        self.sqnorms = None
        self.perm = None
        if dim is None:
            dim = dp - 2 if self.metric == METRIC_L2 else dp
        self.n, self.dim = n, dim
        self.rows = n_pad // S
        self.row_source = row_source
        self._runs = {}
        return self

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        kb: int = 0,
        batch_size: int = 4096,
        cls: int = 0,
        keep2: bool | None = None,
        prerank: int = 0,
    ) -> tuple[np.ndarray, np.ndarray]:
        from shine_tpu.models.flat import cls_auto, kb_auto, keep2_auto

        if kb <= 0:
            # per-shard row count: the scan (and its kb candidate margin)
            # is shard-local; the r4f kb rule applies at the shard scale
            kb = kb_auto(self.rows, self.dim)
        if cls <= 0:
            # same auto-cls rule as FastFlatIndex.search, on the
            # per-shard row count (the scan is shard-local)
            cls = cls_auto(self.rows)
        if keep2 is None:
            keep2 = keep2_auto(self.rows, cls)
        kb = max(kb, k)
        nq, d = queries.shape
        batch_size = min(batch_size, max(nq, 1))
        capacity = self.vectors is None
        key = (k, kb, cls, batch_size, keep2, prerank)
        if key not in self._runs:
            if capacity:
                self._runs[key] = _make_search_ext(
                    self.mesh, k, kb, cls, self.metric, self.rows,
                    keep2=keep2, with_regen=self.row_source is not None,
                    prerank=prerank,
                )
            else:
                self._runs[key] = _make_search(
                    self.mesh, k, kb, cls, self.metric, self.rows,
                    keep2=keep2, prerank=prerank,
                )
        run = self._runs[key]
        rep = NamedSharding(self.mesh, P())
        extra = ()
        if capacity and self.row_source is not None:
            extra = tuple(self.row_source)
        out_i = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            q = queries[lo:hi].astype(np.float32)
            if hi - lo < batch_size:
                q = np.concatenate(
                    [q, np.zeros((batch_size - (hi - lo), d), np.float32)]
                )
            qd = jax.device_put(jnp.asarray(q), rep)
            if capacity:
                dd, ii = run(self.ext, qd, *extra)
            else:
                dd, ii = run(self.ext, self.vectors, self.sqnorms, qd)
            out_d[lo:hi] = np.asarray(dd)[: hi - lo]
            out_i[lo:hi] = np.asarray(ii)[: hi - lo]
        # shards whose row range is entirely padding return pad rows with
        # inf dists; inside shard_map the local `cand_local < rows` mask
        # can't see the global n, so drop ids >= n here before the perm
        # remap (which is only n long)
        out_i = np.where(out_i < self.n, out_i, -1)
        if self.perm is not None:
            out_i = np.where(out_i >= 0, self.perm[np.maximum(out_i, 0)], -1)
        return out_i, out_d

    def cost_counters(self, nq: int, k: int = 10, *, kb: int = 0,
                      batch_size: int = 4096) -> dict:
        """Cluster-total analytic cost: each batch streams the full (row-
        sharded) ext table once; each shard re-ranks kb local survivors;
        the merge all_gathers (B, kb) (dist, id) lanes. kb=0 resolves via
        the same kb_auto rule search() uses, so the counters report the
        actual auto serving config."""
        if kb <= 0:
            from shine_tpu.models.flat import kb_auto

            kb = kb_auto(self.rows, self.dim)
        S = self.mesh.devices.size
        n_pad = int(self.ext.shape[0])
        batches = -(-nq // max(batch_size, 1))
        return {
            "distance_computations": nq * n_pad + nq * kb * S,
            "scanned_rows": nq * n_pad,
            "hbm_gather_bytes": batches * int(self.ext.nbytes)
            + nq * kb * S * self.dim * 4,
            "ici_exchange_bytes": nq * self.dim * 4 * (S - 1)
            + nq * kb * 8 * (S - 1),
        }
