"""Device-resident synthetic datasets for beyond-host-scale validation.

The reference validates on big-ann files staged on NFS near the nodes
(io/read_data.hh, scripts/data/download.sh). There is no network here,
and generating a 10M x 128 base (5 GB) on the host and uploading it is
slow. This module generates the same mixture-of-Gaussians family as
io/datasets.synthetic_dataset directly in device memory (chunked, so
peak extra memory is one chunk), and computes exact ground truth on
device with the f32 flat scan. Only queries and ground truth ids (a few
MB) ever touch the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from shine_tpu.ops.packing import ext_width, pack_ext_rows


@dataclass
class DeviceDataset:
    base_dev: jnp.ndarray  # (n, d) f32, device-resident
    queries: np.ndarray  # (q, d) f32, host
    ground_truth: np.ndarray | None  # (q, k) i32, host
    metric: str = "l2"
    name: str = "device-synth"

    @property
    def n(self) -> int:
        return self.base_dev.shape[0]


@partial(jax.jit, static_argnames=("n", "dim", "rchunk", "normalize"))
def _gen_base(key, centers, *, n: int, dim: int, rchunk: int,
              normalize: bool):
    """Chunked mixture-of-Gaussians base: scan stacks bf16-free f32 chunks
    straight into the (n, dim) output, so generation never holds more than
    output + one chunk."""
    nc = centers.shape[0]
    ks = jax.random.split(key, n // rchunk)

    def body(_, kc):
        ka, kn = jax.random.split(kc)
        assign = jax.random.randint(ka, (rchunk,), 0, nc)
        x = centers[assign] + jax.random.normal(kn, (rchunk, dim), jnp.float32)
        if normalize:
            x = x / (jnp.linalg.norm(x, axis=1, keepdims=True) + 1e-30)
        return None, x

    _, base = jax.lax.scan(body, None, ks)
    return base.reshape(n, dim)


def device_synthetic_dataset(
    n: int = 10_000_000,
    dim: int = 128,
    num_queries: int = 2048,
    *,
    metric: str = "l2",
    num_clusters: int = 64,
    seed: int = 0,
    gt_k: int = 10,
    compute_gt: bool = True,
    rchunk: int = 65536,
) -> DeviceDataset:
    """Mixture-of-Gaussians base generated on device; queries drawn near base
    rows; exact f32 ground truth computed on-device (FlatIndex bf16-free).
    n is rounded up to a multiple of 4096 (the class-max scan quantum) so the
    device constructors never need a padding copy."""
    n = -(-n // 4096) * 4096
    while n % rchunk:
        rchunk //= 2
    k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 4)
    centers = jax.random.normal(k0, (num_clusters, dim), jnp.float32) * 4.0
    base = _gen_base(
        k1, centers, n=n, dim=dim, rchunk=rchunk, normalize=(metric == "ip")
    )
    qidx = jax.random.randint(k2, (num_queries,), 0, n)
    queries = base[qidx] + 0.3 * jax.random.normal(
        k3, (num_queries, dim), jnp.float32
    )
    if metric == "ip":
        queries = queries / (
            jnp.linalg.norm(queries, axis=1, keepdims=True) + 1e-30
        )
    queries_np = np.asarray(queries)
    gt = None
    if compute_gt:
        from shine_tpu.models.flat import FlatIndex

        flat = FlatIndex.from_device(base, metric, with_bf16=False)
        gt, _ = flat.search(queries_np, gt_k, use_bf16=False)
        del flat
    return DeviceDataset(
        base_dev=base,
        queries=queries_np,
        ground_truth=gt,
        metric=metric,
        name=f"device-synth-{n}x{dim}",
    )


@dataclass
class DeviceExtDataset:
    ext_dev: jnp.ndarray  # (n_pad, dp) bf16 packed score table
    n: int
    queries: np.ndarray
    ground_truth: np.ndarray | None
    metric: str = "l2"
    name: str = "device-synth-ext"
    regen: object = None  # (chunk_index) -> (rchunk, d) f32 rows; chunks
    # are pure functions of their PRNG key, so the f32 base is
    # re-derivable without ever being resident (used by
    # streaming_eps_recall for exact distance checks)
    rchunk: int = 0
    row_source: object = None  # (key, centers) for row-keyed datasets:
    # ANY row regenerable by global id via regen_rows — enables the
    # exact in-jit re-rank (ops/distance.py:regen_rerank_topk)


def device_synthetic_ext_dataset(
    n: int = 20_000_000,
    dim: int = 128,
    num_queries: int = 2048,
    *,
    metric: str = "l2",
    num_clusters: int = 64,
    seed: int = 0,
    gt_k: int = 10,
    rchunk: int = 262_144,
) -> DeviceExtDataset:
    """Streaming ingestion for beyond-base-scale rows: each generated f32
    chunk is (1) folded into an exact running ground-truth top-k for the
    queries and (2) packed into the bf16 score table — the full f32 base
    is NEVER resident, so capacity is set by the ext table alone. The moral
    equivalent of the reference streaming round-robin partitions off NFS
    (io/read_data.hh:57-77) straight into MN hugepages.
    """
    n = -(-n // 4096) * 4096
    while n % rchunk:
        rchunk //= 2
    dp = ext_width(dim)
    k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 4)
    centers = jax.random.normal(k0, (num_clusters, dim), jnp.float32) * 4.0
    nc = num_clusters
    metric_l2 = metric != "ip"

    # queries anchored to real base rows (same property as
    # device_synthetic_dataset — every query has a strong near neighbor;
    # unanchored mixture draws measured id-recall 0.68 vs 0.92 purely
    # from tie density): chunk 0 is deterministic from its key, so
    # regenerate it and anchor there
    keys = jax.random.split(k1, n // rchunk)
    ka0, kn0 = jax.random.split(keys[0])
    a0 = jax.random.randint(ka0, (rchunk,), 0, nc)
    x0 = centers[a0] + jax.random.normal(kn0, (rchunk, dim), jnp.float32)
    if not metric_l2:
        x0 = x0 / (jnp.linalg.norm(x0, axis=1, keepdims=True) + 1e-30)
    qidx = jax.random.randint(k2, (num_queries,), 0, rchunk)
    queries = x0[qidx] + 0.3 * jax.random.normal(
        k3, (num_queries, dim), jnp.float32
    )
    if not metric_l2:
        queries = queries / (
            jnp.linalg.norm(queries, axis=1, keepdims=True) + 1e-30
        )
    qn = jnp.sum(queries * queries, axis=1)

    @partial(jax.jit, static_argnames=("rchunk_", "dim_"), donate_argnums=(0,))
    def step(ext, carry, kc, off, *, rchunk_: int, dim_: int):
        gt_d, gt_i = carry
        ka_, kn_ = jax.random.split(kc)
        a = jax.random.randint(ka_, (rchunk_,), 0, nc)
        x = centers[a] + jax.random.normal(kn_, (rchunk_, dim_), jnp.float32)
        if not metric_l2:
            x = x / (jnp.linalg.norm(x, axis=1, keepdims=True) + 1e-30)
        sq = jnp.sum(x * x, axis=1)
        # exact f32 GT fold
        dots = jax.lax.dot_general(
            queries, x, (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        dd = (qn[:, None] - 2.0 * dots + sq[None, :]) if metric_l2 else (
            1.0 - dots
        )
        ids = off + jax.lax.broadcasted_iota(
            jnp.int32, (num_queries, rchunk_), 1
        )
        all_d = jnp.concatenate([gt_d, dd], axis=1)
        all_i = jnp.concatenate([gt_i, ids], axis=1)
        nd, sel = jax.lax.top_k(-all_d, gt_k)
        carry = (-nd, jnp.take_along_axis(all_i, sel, axis=1))
        # pack the ext chunk in place
        ext = jax.lax.dynamic_update_slice_in_dim(
            ext, pack_ext_rows(x, sq, ext.shape[1], metric_l2), off, 0
        )
        return ext, carry

    ext = jnp.zeros((n, dp), jnp.bfloat16)
    gt_d = jnp.full((num_queries, gt_k), jnp.inf, jnp.float32)
    gt_i = jnp.full((num_queries, gt_k), -1, jnp.int32)
    carry = (gt_d, gt_i)
    for c in range(n // rchunk):
        ext, carry = step(
            ext, carry, keys[c], c * rchunk, rchunk_=rchunk, dim_=dim
        )
    gt = np.asarray(carry[1])

    @partial(jax.jit, static_argnames=())
    def _regen(kc):
        ka_, kn_ = jax.random.split(kc)
        a = jax.random.randint(ka_, (rchunk,), 0, nc)
        x = centers[a] + jax.random.normal(kn_, (rchunk, dim), jnp.float32)
        if not metric_l2:
            x = x / (jnp.linalg.norm(x, axis=1, keepdims=True) + 1e-30)
        return x

    return DeviceExtDataset(
        ext_dev=ext,
        n=n,
        queries=np.asarray(queries),
        ground_truth=gt,
        metric=metric,
        name=f"device-synth-ext-{n}x{dim}",
        regen=lambda c: _regen(keys[c]),
        rchunk=rchunk,
    )


@dataclass
class DeviceSplitDataset:
    comp_dev: jnp.ndarray  # (n_pad, dpc) bf16 or int8 component table
    aux_dev: jnp.ndarray  # (2, n_pad) f32: [0]=nrm, [1]=scl
    n: int
    queries: np.ndarray
    ground_truth: np.ndarray | None
    metric: str = "l2"
    name: str = "device-split"
    row_source: object = None  # (key, centers): exact per-id regen


def device_rowkeyed_split_dataset(
    n: int = 40_000_000,
    dim: int = 128,
    num_queries: int = 2048,
    *,
    metric: str = "l2",
    comp_dtype: str = "int8",
    num_clusters: int = 64,
    seed: int = 0,
    gt_k: int = 10,
    rchunk: int = 131_072,
    mesh=None,
) -> DeviceSplitDataset:
    """Row-keyed streaming ingestion into the SPLIT layout
    (ops/packing.py): bf16/int8 components + f32 (nrm, scl) — 264 B/row
    (bf16) or 136 B/row (int8) at d=128 vs the packed ext table's 320.
    Same
    bit-identical single-chip/sharded property as
    device_rowkeyed_ext_dataset (rows are pure functions of
    fold_in(key, global_id)); exact f32 GT folded during the stream;
    `row_source` enables exact regen re-ranking at search time."""
    from shine_tpu.ops.packing import (
        SPLIT_QUANTUM,
        comp_width,
        pack_split_device,
    )

    S = mesh.devices.size if mesh is not None else 1
    n = -(-n // (SPLIT_QUANTUM * S)) * SPLIT_QUANTUM * S
    while n % (rchunk * S) or rchunk > n // S:
        rchunk //= 2
        if rchunk == 0:
            raise ValueError(f"n={n} not tileable over {S} shards")
    dpc = comp_width(dim)
    int8 = comp_dtype == "int8"
    k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 4)
    centers = jax.random.normal(k0, (num_clusters, dim), jnp.float32) * 4.0
    metric_l2 = metric != "ip"
    metric_id_ = 0 if metric_l2 else 1

    qidx = jax.random.randint(k2, (num_queries,), 0, n)
    anchors = regen_rows(k1, centers, qidx, normalize=not metric_l2)
    queries = anchors + 0.3 * jax.random.normal(
        k3, (num_queries, dim), jnp.float32
    )
    if not metric_l2:
        queries = queries / (
            jnp.linalg.norm(queries, axis=1, keepdims=True) + 1e-30
        )
    queries = jax.device_put(np.asarray(queries))
    qn = jnp.sum(queries * queries, axis=1)

    def ingest_span(lo, n_loc):
        def body(carry, c):
            gt_d, gt_i = carry
            ids = lo + c * rchunk + jnp.arange(rchunk, dtype=jnp.int32)
            x = regen_rows(k1, centers, ids, normalize=not metric_l2)
            sq = jnp.sum(x * x, axis=1)
            dots = jax.lax.dot_general(
                queries, x, (((1,), (1,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )
            dd = (
                qn[:, None] - 2.0 * dots + sq[None, :]
            ) if metric_l2 else (1.0 - dots)
            all_d = jnp.concatenate([gt_d, dd], axis=1)
            all_i = jnp.concatenate(
                [gt_i, jnp.broadcast_to(ids[None, :], dd.shape)], axis=1
            )
            nd, sel = jax.lax.top_k(-all_d, gt_k)
            comp_c, aux_c = pack_split_device(
                x, metric=metric_id_, dpc=dpc, int8=int8, rchunk=rchunk
            )
            return (-nd, jnp.take_along_axis(all_i, sel, axis=1)), (
                comp_c, aux_c
            )

        gt0 = (
            jnp.full((num_queries, gt_k), jnp.inf, jnp.float32),
            jnp.full((num_queries, gt_k), -1, jnp.int32),
        )
        (gt_d, gt_i), (comp, aux) = jax.lax.scan(
            body, gt0, jnp.arange(n_loc // rchunk, dtype=jnp.int32)
        )
        # aux chunks stack as (chunks, 2, rchunk) -> (2, n_loc)
        aux = jnp.moveaxis(aux, 1, 0).reshape(2, n_loc)
        return comp.reshape(n_loc, dpc), aux, gt_d, gt_i

    if mesh is None:
        comp, aux, _, gt_i = jax.jit(
            ingest_span, static_argnums=(0, 1)
        )(0, n)
        gt = np.asarray(gt_i)
    else:
        from jax.sharding import PartitionSpec as P

        from shine_tpu.parallel.mesh import SHARD_AXIS

        n_loc = n // S

        def spmd():
            my = jax.lax.axis_index(SHARD_AXIS)
            comp_loc, aux_loc, gt_d, gt_i = ingest_span(my * n_loc, n_loc)
            all_d = jax.lax.all_gather(gt_d, SHARD_AXIS)
            all_i = jax.lax.all_gather(gt_i, SHARD_AXIS)
            all_d = jnp.moveaxis(all_d, 0, 1).reshape(num_queries, -1)
            all_i = jnp.moveaxis(all_i, 0, 1).reshape(num_queries, -1)
            nd, sel = jax.lax.top_k(-all_d, gt_k)
            return comp_loc, aux_loc, jnp.take_along_axis(all_i, sel, axis=1)

        run = jax.jit(
            jax.shard_map(
                spmd, mesh=mesh, in_specs=(),
                out_specs=(P(SHARD_AXIS), P(None, SHARD_AXIS), P()),
                check_vma=False,
            )
        )
        comp, aux, gt_i = run()
        gt = np.asarray(gt_i)

    return DeviceSplitDataset(
        comp_dev=comp,
        aux_dev=aux,
        n=n,
        queries=np.asarray(queries),
        ground_truth=gt,
        metric=metric,
        name=f"device-rowkeyed-split-{n}x{dim}-{comp_dtype}",
        row_source=(k1, centers),
    )


def streaming_eps_recall(
    ds: DeviceExtDataset,
    found_ids: np.ndarray,
    k: int,
    *,
    rtol: float = 1e-4,
) -> float:
    """Distance-tolerance recall for a streaming ext dataset: exact f32
    distances are recomputed by regenerating only the chunks the found /
    ground-truth ids live in (io/recall.py:recall_at_k_eps needs the
    resident base; here the base never existed as one array)."""
    assert ds.regen is not None and ds.rchunk
    found = np.asarray(found_ids)[:, :k]
    gt = np.asarray(ds.ground_truth)[:, :k]
    qd = jnp.asarray(ds.queries.astype(np.float32))

    @jax.jit
    def pair_d(x, local):
        v = x[local]  # (Q, K, d)
        if ds.metric != "ip":
            return jnp.sum((qd[:, None, :] - v) ** 2, axis=-1)
        # HIGHEST: DEFAULT may run f32 operands at bf16 or TF32 grade —
        # this is an exactness oracle (see models/flat.py:flat_search).
        return 1.0 - jnp.einsum(
            "qd,qkd->qk", qd, v, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )

    def exact(ids):
        out = np.full(ids.shape, np.inf, np.float32)
        chunks = np.unique(ids[ids >= 0] // ds.rchunk)
        for c in chunks:
            sel = (ids >= 0) & (ids // ds.rchunk == c)
            if not sel.any():
                continue
            x = ds.regen(int(c))
            local = jnp.asarray(np.where(sel, ids % ds.rchunk, 0))
            out = np.where(sel, np.asarray(pair_d(x, local)), out)
        return out

    df = exact(found)
    dg = exact(gt)
    thresh = np.sort(dg, axis=1)[:, k - 1] * (1.0 + rtol) + 1e-12
    return float((df <= thresh[:, None]).mean())


# ---------------------------------------------------------------------------
# Row-keyed generation (r3): every row derives from fold_in(key, row_id),
# so ANY row is exactly regenerable in O(d) inside a jit — independent of
# chunking, sharding, or generation order. This powers
# (1) the capacity mode's EXACT f32 re-rank without a resident base
#     (ops/distance.py:regen_rerank_topk) — the precision escape hatch
#     over bf16 ext-table re-ranking, and
# (2) sharded streaming ingestion that is bit-identical to single-chip
#     (each shard generates its own row range from the same keys).
# The reference's analogue of (2) is round-robin NFS partitions streamed
# straight into MN hugepages (/root/reference/src/io/read_data.hh:57-77).


def regen_rows(key, centers, ids, *, normalize: bool = False):
    """Exactly regenerate base rows by global id: (m,) i32 -> (m, d) f32.
    Pure function of (key, centers, id) — jit/vmap/shard-safe."""
    nc, d = centers.shape

    def one(i):
        kk = jax.random.fold_in(key, i)
        ka, kn = jax.random.split(kk)
        a = jax.random.randint(ka, (), 0, nc)
        x = centers[a] + jax.random.normal(kn, (d,), jnp.float32)
        if normalize:
            x = x / (jnp.linalg.norm(x) + 1e-30)
        return x

    return jax.vmap(one)(ids)


def device_rowkeyed_ext_dataset(
    n: int = 20_000_000,
    dim: int = 128,
    num_queries: int = 2048,
    *,
    metric: str = "l2",
    num_clusters: int = 64,
    seed: int = 0,
    gt_k: int = 10,
    rchunk: int = 131_072,
    mesh=None,
) -> DeviceExtDataset:
    """Streaming row-keyed ingestion: generates the packed bf16 ext table
    chunk by chunk (the f32 base is never resident), folds an exact f32
    running ground truth, and — because rows are keyed by GLOBAL id —
    produces bit-identical data whether built single-chip or row-sharded
    over a mesh (mesh=...). The returned dataset carries `row_source`
    (key, centers) for search-time exact regen re-ranking.
    """
    S = mesh.devices.size if mesh is not None else 1
    # per-shard row counts must stay multiples of the 4096 scan quantum
    # (ShardedFastFlatIndex.from_ext asserts n_pad % (4096 * S))
    n = -(-n // (4096 * S)) * 4096 * S
    while n % (rchunk * S) or rchunk > n // S:
        rchunk //= 2
        if rchunk == 0:
            raise ValueError(f"n={n} not tileable over {S} shards")
    dp = ext_width(dim)
    k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 4)
    centers = jax.random.normal(k0, (num_clusters, dim), jnp.float32) * 4.0
    metric_l2 = metric != "ip"

    # queries anchored to real base rows (regenerable from any id — no
    # chunk-0 special case as in device_synthetic_ext_dataset)
    qidx = jax.random.randint(k2, (num_queries,), 0, n)
    anchors = regen_rows(k1, centers, qidx, normalize=not metric_l2)
    queries = anchors + 0.3 * jax.random.normal(
        k3, (num_queries, dim), jnp.float32
    )
    if not metric_l2:
        queries = queries / (
            jnp.linalg.norm(queries, axis=1, keepdims=True) + 1e-30
        )
    queries = jax.device_put(np.asarray(queries))  # host-roundtrip: frozen
    qn = jnp.sum(queries * queries, axis=1)

    def ingest_span(lo, n_loc):
        """Generate rows [lo, lo+n_loc): (n_loc, dp) bf16 ext + exact
        local GT fold over the replicated queries. Pure jax — runs both
        single-chip and inside shard_map."""

        def body(carry, c):
            gt_d, gt_i = carry
            ids = lo + c * rchunk + jnp.arange(rchunk, dtype=jnp.int32)
            x = regen_rows(k1, centers, ids, normalize=not metric_l2)
            sq = jnp.sum(x * x, axis=1)
            dots = jax.lax.dot_general(
                queries, x, (((1,), (1,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )
            dd = (
                qn[:, None] - 2.0 * dots + sq[None, :]
            ) if metric_l2 else (1.0 - dots)
            all_d = jnp.concatenate([gt_d, dd], axis=1)
            all_i = jnp.concatenate(
                [gt_i, jnp.broadcast_to(ids[None, :], dd.shape)], axis=1
            )
            nd, sel = jax.lax.top_k(-all_d, gt_k)
            return (-nd, jnp.take_along_axis(all_i, sel, axis=1)), (
                pack_ext_rows(x, sq, dp, metric_l2)
            )

        gt0 = (
            jnp.full((num_queries, gt_k), jnp.inf, jnp.float32),
            jnp.full((num_queries, gt_k), -1, jnp.int32),
        )
        (gt_d, gt_i), ext = jax.lax.scan(
            body, gt0, jnp.arange(n_loc // rchunk, dtype=jnp.int32)
        )
        return ext.reshape(n_loc, dp), gt_d, gt_i

    if mesh is None:
        ext, gt_d, gt_i = jax.jit(ingest_span, static_argnums=(0, 1))(0, n)
        gt = np.asarray(gt_i)
    else:
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        from shine_tpu.parallel.mesh import SHARD_AXIS

        n_loc = n // S

        def spmd():
            my = jax.lax.axis_index(SHARD_AXIS)
            ext_loc, gt_d, gt_i = ingest_span(my * n_loc, n_loc)
            # merge per-shard exact folds into the global top-k
            all_d = jax.lax.all_gather(gt_d, SHARD_AXIS)  # (S, q, k)
            all_i = jax.lax.all_gather(gt_i, SHARD_AXIS)
            all_d = jnp.moveaxis(all_d, 0, 1).reshape(num_queries, -1)
            all_i = jnp.moveaxis(all_i, 0, 1).reshape(num_queries, -1)
            nd, sel = jax.lax.top_k(-all_d, gt_k)
            return ext_loc, jnp.take_along_axis(all_i, sel, axis=1)

        run = jax.jit(
            jax.shard_map(
                spmd, mesh=mesh, in_specs=(),
                out_specs=(P(SHARD_AXIS), P()), check_vma=False,
            )
        )
        ext, gt_i = run()
        gt = np.asarray(gt_i)

    return DeviceExtDataset(
        ext_dev=ext,
        n=n,
        queries=np.asarray(queries),
        ground_truth=gt,
        metric=metric,
        name=f"device-rowkeyed-{n}x{dim}",
        regen=jax.jit(
            lambda c: regen_rows(
                k1, centers,
                c * rchunk + jnp.arange(rchunk, dtype=jnp.int32),
                normalize=(metric == "ip"),
            )
        ),
        rchunk=rchunk,
        row_source=(k1, centers),
    )


def rowkeyed_scorer_crosscheck(
    row_source, queries, *, n_sub: int = 524_288, n_eval: int = 128,
    metric: str | int = "l2", rchunk: int = 65_536,
) -> float:
    """Scorer self-certification for capacity-scale runs whose base never
    exists on host: regenerate the first n_sub rows on device (exact,
    row-keyed), download them, and compare the DEVICE exact scorer
    (flat_search use_bf16=False, the GT pipeline's own path) against the
    pure-numpy oracle on that subset. Returns top-10 overlap — 1.0
    certifies the device scorer's precision configuration; the r4
    incident (DEFAULT matmul truncating the f32 GT leg to bf16) scores
    ~0.93 here. The subset shares the full run's (d, metric, density),
    which is what the bug class keys on."""
    from shine_tpu.config import METRIC_L2, metric_id
    from shine_tpu.io.recall import numpy_subset_gt, recall_at_k
    from shine_tpu.models.flat import FlatIndex

    m = metric_id(metric)
    key, centers = row_source
    normalize = m != METRIC_L2
    parts = []
    for lo in range(0, n_sub, rchunk):
        ids = jnp.arange(lo, min(lo + rchunk, n_sub), dtype=jnp.int32)
        parts.append(np.asarray(
            regen_rows(key, centers, ids, normalize=normalize)
        ))
    sub = np.concatenate(parts, axis=0)
    q = np.asarray(queries)[:n_eval].astype(np.float32)
    idx = FlatIndex(sub, metric=m)
    dev_ids, _ = idx.search(q, 10, use_bf16=False)
    gt_np = numpy_subset_gt(q, sub, 10, metric=m)
    return float(recall_at_k(dev_ids, gt_np, 10))
