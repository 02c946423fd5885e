"""Scan-speed HNSW construction: exact kNN graph + heuristic pruning.

The reference builds incrementally — every insert runs an ef_construction
beam search against the partial graph under remote locks
(reference src/hnsw/hnsw.hh:40-251). On an accelerator that
traversal is gather-bound, but the class-max scan (ops/classmax.py)
computes near-exact nearest neighbors at matmul rate. So construction
flips:

  1. scan the base against itself -> 2M-NN per node (exact f32 re-rank
     of the scan's candidates);
  2. select each node's M diverse neighbors with the reference's
     heuristic (select_heuristic, hnsw.hh:482-522) — vectorized, batched
     on device;
  3. add reverse edges with deterministic nearest-first capping, then
     re-prune overflowing vertices with the same heuristic (the batched
     analogue of the reference's shrink-on-overflow, hnsw.hh:180-225);
  4. upper layers: the same recipe on the level->l subsets (tiny);
     entry point = the max-level node (lowest id).

Graphs built this way search with the same machinery (models/hnsw.py,
parallel/sharded.py) and match or beat the incremental builder's recall:
the kNN stage is exact rather than beam-approximate.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from functools import partial

import jax

from shine_tpu.config import METRIC_L2, HNSWParams
from shine_tpu.graph.soa import GraphSoA
from shine_tpu.models.build import draw_levels, select_heuristic

# rows below this build their kNN stage single-device even under a mesh
# (collective overhead beats the win at toy shards); tests lower it to
# force the sharded path on the CPU mesh
SHARD_KNN_MIN = 32768


@partial(jax.jit, static_argnames=("M_out", "metric", "with_dists"))
def _select_batch(vdev, sdev, ci, cd, *, M_out, metric, with_dists=False):
    cv = vdev[jnp.maximum(ci, 0)]
    cs = sdev[jnp.maximum(ci, 0)]
    return select_heuristic(
        ci, cd, cv, cs, M_out, metric, fill=True, with_dists=with_dists
    )


def _device_select(
    vectors,
    sqn,
    node_ids: np.ndarray,  # (B,) query nodes
    cand: np.ndarray,  # (B, C) candidate ids sorted by (dist, id), -1 pad
    cand_d: np.ndarray,  # (B, C)
    M_out: int,
    metric: int,
    batch: int = 8192,
    with_dists: bool = False,
):
    """Batched diversity selection on device. Returns (sel (B, M_out),
    n_sel (B,)[, sel_d (B, M_out)]). Batches dispatch asynchronously;
    results download in a few large groups. The select program is a
    module-level jit so it compiles once per (shape, M_out, metric)
    across all calls. vectors/sqn may already be device arrays (the 10M
    device build reuses its resident base instead of re-uploading it per
    level)."""
    vdev = vectors if isinstance(vectors, jnp.ndarray) else jnp.asarray(vectors)
    sdev = sqn if isinstance(sqn, jnp.ndarray) else jnp.asarray(sqn)
    B, C = cand.shape
    # bucket the batch to a power of two (floor 256) so the levels of a
    # hierarchy share compiled select programs instead of compiling one
    # per level shape
    batch = min(batch, 1 << max(8, (B - 1).bit_length()))
    # the pairwise tile is (batch, C, C) f32 + a (batch, C, d) gather;
    # wide efc-parity pools (C ~ 500) would put the default batch at
    # ~9 GB of device memory — halve until the tile budget holds (floor
    # 256)
    d_ = int(vdev.shape[1])
    while batch > 256 and batch * C * (C + d_) * 4 > 2_500_000_000:
        batch //= 2

    # stream results to host in ~512 MB groups: accumulating all of them
    # and concatenating once holds 2x the full (B, M_out) output on
    # device (8.6 GB at 16.78M rows / M0=64, beside an 8.6 GB f32 base).
    # A group concat keeps each download large while bounding device
    # residency of staged outputs to ~1 GB.
    import os as _os

    out_bytes = batch * (M_out + 1) * 4 * (2 if with_dists else 1)
    flush_mb = float(_os.environ.get("SHINE_SELECT_FLUSH_MB", 512))
    group = max(1, int(flush_mb * 1e6) // max(out_bytes, 1))
    pending: list = []
    host_parts: list = []

    def _flush():
        if not pending:
            return
        if len(pending) == 1:
            grp = pending[0]
        else:
            grp = tuple(
                jnp.concatenate([p[j] for p in pending], axis=0)
                for j in range(len(pending[0]))
            )
        host_parts.append(tuple(np.asarray(o) for o in grp))
        pending.clear()

    for lo in range(0, B, batch):
        hi = min(lo + batch, B)
        ci = np.full((batch, C), -1, np.int32)
        ci[: hi - lo] = cand[lo:hi]
        cdp = np.full((batch, C), np.inf, np.float32)
        cdp[: hi - lo] = cand_d[lo:hi]
        pending.append(
            _select_batch(
                vdev, sdev, jnp.asarray(ci), jnp.asarray(cdp),
                M_out=M_out, metric=metric, with_dists=with_dists,
            )
        )
        if len(pending) >= group:
            _flush()
    _flush()
    if len(host_parts) == 1:
        outs = host_parts[0]
    else:
        outs = tuple(
            np.concatenate([p[j] for p in host_parts], axis=0)
            for j in range(len(host_parts[0]))
        )
    return tuple(o[:B] for o in outs)


def _drop_self_sorted(
    ii: np.ndarray, dd: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Remove the (unique) self-match from rows already sorted by
    (dist, id) and keep k columns. Value-identical to the old
    demote-to-inf + full np.lexsort (the demoted entry becomes (-1, inf)
    — the pad value — so a one-slot shift-left with a pad appended IS
    the sorted result), but O(nk) instead of an (n, k+1) lexsort that
    costs minutes at 10M rows."""
    n, w = ii.shape
    local = np.arange(n, dtype=ii.dtype)[:, None]
    self_hit = ii == local
    has = self_hit.any(axis=1)[:, None]
    h = np.argmax(self_hit, axis=1)[:, None]
    j = np.arange(w)[None, :]
    src = np.where(has & (j >= h), np.minimum(j + 1, w - 1), j)
    out_i = np.take_along_axis(ii, src, axis=1)
    out_d = np.take_along_axis(dd, src, axis=1)
    tail = has & (j == w - 1)
    out_i = np.where(tail, -1, out_i)
    out_d = np.where(tail, np.inf, out_d)
    return out_i[:, :k].astype(np.int32), out_d[:, :k].astype(np.float32)


def _knn_candidates(
    vectors: np.ndarray, ids: np.ndarray, k: int, metric: int,
    exact_knn: bool, mesh=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact-ish kNN of the subset `ids` against itself (self excluded).
    Returns (cand (n, k) as *global* ids, dists (n, k)). With a mesh the
    scan shards over the devices (parallel/fastflat_sharded.py).
    exact_knn takes the exact f32 flat scan instead of the class-max
    scan."""
    from shine_tpu.models.flat import FastFlatIndex, FlatIndex

    sub = vectors[ids]
    n = len(ids)
    if mesh is not None and n > SHARD_KNN_MIN:
        if exact_knn:
            # the exact row-sharded scan — per-row f32 distances are
            # computed identically on every layout, so a mesh build is
            # BIT-identical to the single-device FlatIndex path
            # (tests/test_build.py sharded-fastbuild identity)
            from shine_tpu.parallel import ShardedFlatIndex

            idx = ShardedFlatIndex(sub, mesh, metric=metric)
            ii, dd = idx.search(sub, k + 1, chunk=2048, use_bf16=False)
        else:
            from shine_tpu.parallel.fastflat_sharded import (
                ShardedFastFlatIndex,
            )

            idx = ShardedFastFlatIndex(sub, mesh, metric=metric)
            kb = max(k + 17, 48 if sub.shape[1] < 512 else 128)
            ii, dd = idx.search(sub, k + 1, kb=kb, batch_size=4096)
    elif n <= 32768 or exact_knn:
        idx = FlatIndex(sub, metric=metric)
        ii, dd = idx.search(sub, k + 1, batch_size=2048, use_bf16=not exact_knn)
    else:
        idx = FastFlatIndex(sub, metric=metric)
        pre = idx.preload(sub, batch_size=4096)
        kb = max(k + 17, 48 if sub.shape[1] < 512 else 128)
        ii, dd = idx.search(
            sub, k + 1, kb=kb, batch_size=4096, preloaded=pre
        )
    # drop self matches (rows arrive sorted by (dist, id))
    ii, dd = _drop_self_sorted(np.asarray(ii), np.asarray(dd), k)
    gi = np.where(ii >= 0, ids[np.maximum(ii, 0)], -1)
    return gi.astype(np.int32), dd.astype(np.float32)


@partial(jax.jit, static_argnames=("k",))
def _drop_self_dev(ii, dd, lo, *, k: int):
    """Device twin of _drop_self_sorted for one sweep batch: the batch's
    row b has self id lo + b. Bit-identical shift-left semantics (the
    self hit becomes the (-1, inf) pad at the tail); keeps k columns."""
    B, w = ii.shape
    local = lo + jnp.arange(B, dtype=ii.dtype)[:, None]
    self_hit = ii == local
    has = self_hit.any(axis=1)[:, None]
    h = jnp.argmax(self_hit, axis=1)[:, None]
    j = jnp.arange(w, dtype=jnp.int32)[None, :]
    src = jnp.where(has & (j >= h), jnp.minimum(j + 1, w - 1), j)
    out_i = jnp.take_along_axis(ii, src, axis=1)
    out_d = jnp.take_along_axis(dd, src, axis=1)
    tail = has & (j == w - 1)
    out_i = jnp.where(tail, -1, out_i)
    out_d = jnp.where(tail, jnp.inf, out_d)
    return out_i[:, :k], out_d[:, :k]


def _hbm_budget() -> float:
    """Bytes the sweep may plan: the device's share for an index (the
    rest is XLA scratch and fragmentation, which this plan cannot see)."""
    from shine_tpu.config import device_bytes
    from shine_tpu.models.flat import INDEX_MEMORY_SHARE

    return INDEX_MEMORY_SHARE * device_bytes()


def _sweep_plan(
    n: int, d: int, k: int, kb: int, batch: int, cls: int,
    layout: str, keep2: bool, sel_batch: int = 0, sel_width: int = 0,
    fused: bool = False,
) -> dict:
    """Host-side memory plan for the level-0 device sweep: itemized
    resident + transient bytes, computed BEFORE any device allocation so
    a build that cannot fit errors instantly with the breakdown instead
    of dying RESOURCE_EXHAUSTED an hour in. Sizes are upper-bound
    estimates of the dominant buffers; XLA overhead and small tiles ride
    the headroom between this total and the device's memory.

    fused: the sweep+select pipeline consumes each batch's (k+1) results
    on device (a few in-flight batches + tiny (sb, M) flush buffers)
    instead of staging 64 batches for a host download."""
    from shine_tpu.ops.packing import comp_width, ext_width

    dp = ext_width(d)
    classes = -(-n // cls)
    width = kb * (2 if keep2 else 1)
    if fused and not sel_batch:
        # the fused pipeline's on-device select: sub-batch under the
        # same ~2.5 GB pairwise-tile rule _sweep_select_level0 applies
        sel_batch, sel_width = batch, k
        while sel_batch > 256 and sel_batch * k * (k + d) * 4 > 2_500_000_000:
            sel_batch //= 2
    items = {
        "base_f32": n * d * 4,
        "sqnorms": n * 4,
        "table": (
            n * dp * 2 if layout == "ext"
            else n * comp_width(d) * (1 if layout == "int8" else 2)
            + 2 * n * 4
        ),
        # class-max scan output (m1/a1 [+ m2/a2]) + XLA TopK scratch (~2x)
        "scan_classtable": batch * classes * 8 * (2 if keep2 else 1) * 3,
        "rerank_gather": batch * width * (d * 4 + 8) + batch * (k + 1) * 8,
        # pairwise select tile (batch, C, C) f32 + (batch, C, d) gather
        "select_tile": sel_batch * sel_width * (sel_width + d) * 4,
        "result_flush": (
            4 * batch * (k + 1) * 8 if fused
            else 64 * batch * (k + 1) * 8
        ),
    }
    items["total"] = sum(items.values())
    return items


def _check_sweep_plan(plan: dict, stage: str) -> None:
    budget = _hbm_budget()
    if plan["total"] > budget:
        lines = ", ".join(
            f"{k}={v/1e9:.2f}GB" for k, v in plan.items() if k != "total"
        )
        raise RuntimeError(
            f"fastbuild {stage}: planned memory {plan['total']/1e9:.2f} GB "
            f"exceeds budget {budget/1e9:.2f} GB ({lines}); shrink batch/"
            f"kb"
        )


def _sweep_index(base_dev, k: int, metric: int, fused: bool = False):
    """Pick the scan layout + candidate knobs for a device self-sweep.

    Returns (idx, search_at(lo) -> (dd, ii) device, plan dict).

    PLAN-DRIVEN: candidate (layout, batch) configs are tried in
    preference order and the first whose host-computed memory plan fits
    the budget wins, so an OOM is found before the first allocation.

    Layout ladder (all re-rank exact f32 against the resident base):
      ext    — packed bf16 table (ops/packing.py), scanned by the engine
               ops/classmax.scan_engine() picks; the default.
      bf16   — split layout: bf16 components + f32 aux.
      int8   — int8 split components: the largest bases, where even bf16
               split + f32 base + scan transients do not fit. kb widens
               (quantization-grade scan scores need a larger margin
               before the exact re-rank).
    keep2 auto-enables when (k+1)^2 > #classes — the one-winner-per-class
    scan loses ~k^2/(2*classes) true candidates to class collisions,
    material for wide efc-parity pools (k=501)."""
    from shine_tpu.models.flat import (
        FastFlatIndex,
        SplitFlatIndex,
        fast_flat_search_at,
        split_flat_search_at,
    )

    import os as _os

    n, d = base_dev.shape
    force_split = _os.environ.get("SHINE_SWEEP_SPLIT") == "1"
    force_int8 = _os.environ.get("SHINE_SWEEP_INT8") == "1"
    cls = 1024
    keep2 = (k + 1) * (k + 1) > -(-n // cls)

    def kb_of(layout):
        return max(k + 64, 96) if layout == "int8" else max(k + 17, 48)

    configs = [
        ("ext", 4096), ("bf16", 4096), ("bf16", 2048),
        ("int8", 4096), ("int8", 2048), ("int8", 1024),
    ]
    if force_split or force_int8:
        configs = [c for c in configs if c[0] != "ext"]
    if force_int8:
        configs = [c for c in configs if c[0] == "int8"]
    plan = None
    layout, batch = configs[-1]
    budget = _hbm_budget()
    for lay, b in configs:
        if n % b:
            continue
        p = _sweep_plan(n, d, k, kb_of(lay), b, cls, lay, keep2,
                        fused=fused)
        if p["total"] <= budget:
            layout, batch, plan = lay, b, p
            break
    else:
        plan = _sweep_plan(n, d, k, kb_of(layout), batch, cls, layout,
                           keep2, fused=fused)
        _check_sweep_plan(plan, f"level-0 sweep (n={n}, layout={layout})")
    kb = kb_of(layout)
    use_split = layout != "ext"
    if use_split:
        idx = SplitFlatIndex.from_device(
            base_dev, metric=metric,
            comp_dtype="int8" if layout == "int8" else "bf16",
        )
    else:
        # shuffle=False: the self-sweep slices queries from the index's
        # own vectors at row offsets and reads raw (unremapped) ids —
        # both require the original row order
        idx = FastFlatIndex.from_device(base_dev, metric=metric,
                                        shuffle=False)

    def search_at(lo: int):
        # self-sweep: q_dev=None tells the program to slice queries from
        # the vectors parameter itself, so the base is not passed twice
        if use_split:
            return split_flat_search_at(
                idx.comp, idx.aux, idx.vectors, idx.sqnorms, None, lo,
                k=k + 1, kb=kb, cls=cls, metric=metric, batch=batch,
                keep2=keep2, n=n,
            )
        return fast_flat_search_at(
            idx.ext, idx.vectors, idx.sqnorms, None, lo,
            k=k + 1, kb=kb, cls=cls, metric=metric, batch=batch,
            keep2=keep2, n=n,
        )

    plan.update(layout=layout, kb=kb, keep2=keep2, batch=batch, cls=cls)
    return idx, search_at, plan


def _knn_device_sweep(
    base_dev, k: int, metric: int, *, batch: int = 4096,
    flush_every: int = 64,
) -> tuple[np.ndarray, np.ndarray]:
    """Self-kNN of a DEVICE-resident base via the class-max scan. The
    base is both table and query set, so nothing leaves the device
    except the (n, k+1) results, downloaded in bounded flushes. Returns
    global-id (cand (n, k), dists) with self-matches removed.

    NOTE: at 10M+ this (n, k+1) download is large (8.7 GB at 16.78M x
    65; 42 GB at 10.5M x pool=500 — host-RAM infeasible).
    The production layer-0 path is _sweep_select_level0, which keeps the
    kNN table on device and downloads only the (n, M) selection; this
    host-table variant remains for diagnostics and as the reference for
    its identity test."""
    idx, search_at, plan = _sweep_index(base_dev, k, metric)
    batch = plan["batch"]  # plan-driven (may shrink below the default)
    n = int(idx.n)
    assert n % batch == 0, "device sweep wants batch | n"
    out_i = np.empty((n, k + 1), np.int32)
    out_d = np.empty((n, k + 1), np.float32)
    buf: list = []

    def flush():
        for lo_, (dd_, ii_) in buf:
            out_d[lo_: lo_ + batch] = np.asarray(dd_)
            out_i[lo_: lo_ + batch] = np.asarray(ii_)
        buf.clear()

    for lo in range(0, n, batch):
        buf.append((lo, search_at(lo)))
        if len(buf) >= flush_every:
            flush()
    flush()
    # drop self matches (rows arrive sorted by (dist, id)), keep k
    return _drop_self_sorted(out_i, out_d, k)


def _sweep_select_level0(
    base_dev, vsel, ssel, k: int, m_out: int, metric: int, *,
    flush_every: int = 32,
) -> tuple[np.ndarray, np.ndarray]:
    """Fused layer-0 kNN + diversity selection, all on device: per batch,
    scan+exact-rerank the top (k+1), drop the self hit, run
    select_heuristic(m_out) — only the (n, m_out) selection (ids +
    dists) ever leaves the device.

    This is what retires the efc-parity host-table tax (VERDICT r4 #2):
    at pool=500/10.5M the old path downloaded a 42 GB (n, 501) table for
    the host merge; here the merge's input is the 2.7 GB (n, M)
    selection, and the native reverse merge + batched select2 upload
    stay exactly as before (bit-identical results to the host-table
    route — tests/test_build.py sweep-select identity)."""
    idx, search_at, plan = _sweep_index(base_dev, k, metric, fused=True)
    n, d = int(idx.n), int(idx.dim)
    batch = plan["batch"]
    assert n % batch == 0, "device sweep wants batch | n"
    # select sub-batch under the pairwise tile budget (same rule as
    # _device_select and the fused _sweep_plan: (sb, C, C) f32 +
    # (sb, C, d) gather <= ~2.5 GB)
    sb = batch
    while sb > 256 and sb * k * (k + d) * 4 > 2_500_000_000:
        sb //= 2
    out_i = np.empty((n, m_out), np.int32)
    out_d = np.empty((n, m_out), np.float32)
    buf: list = []

    def flush():
        for lo_, (si_, sd_) in buf:
            out_i[lo_: lo_ + sb] = np.asarray(si_)
            out_d[lo_: lo_ + sb] = np.asarray(sd_)
        buf.clear()

    for lo in range(0, n, batch):
        dd, ii = search_at(lo)
        ci, cd = _drop_self_dev(ii, dd, jnp.int32(lo), k=k)
        for slo in range(0, batch, sb):
            sel, _, sd = _select_batch(
                vsel, ssel, ci[slo: slo + sb], cd[slo: slo + sb],
                M_out=m_out, metric=metric, with_dists=True,
            )
            buf.append((lo + slo, (sel, sd)))
            if len(buf) >= flush_every:
                flush()
    flush()
    return out_i, out_d


def _reverse_merge(
    fwd_sel: np.ndarray,
    fwd_d: np.ndarray,
    ids: np.ndarray,
    cap_c: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Reverse-edge merge; dispatches to the native C++ stage (bit-identical
    to the numpy twin below — tests/test_fastbuild.py asserts equality on
    adversarial ties) unless SHINE_FASTBUILD_NATIVE=0. numpy's three global
    lexsorts cost 545 s of a 1924 s 10M x M=16 build on one host core;
    the native stage is a counting sort + per-row small sorts."""
    import os

    if os.environ.get("SHINE_FASTBUILD_NATIVE", "1") != "0":
        try:
            from shine_tpu.native import reverse_merge

            return reverse_merge(fwd_sel, fwd_d, ids, cap_c)
        except Exception:  # toolchain missing: the numpy twin is exact
            pass
    return _reverse_merge_np(fwd_sel, fwd_d, ids, cap_c)


def _reverse_merge_np(
    fwd_sel: np.ndarray,  # (n, M) selected forward edges (global ids)
    fwd_d: np.ndarray,  # (n, M) their distances
    ids: np.ndarray,  # (n,) global ids of these nodes
    cap_c: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-vertex candidate sets = forward ∪ incoming, nearest-first capped
    at cap_c. Returns (cand (n, cap_c) global ids, approximate dists).
    Deterministic: ties and caps resolve by (dist, id)."""
    n, M = fwd_sel.shape
    row_of = np.full(int(ids.max()) + 2, -1, np.int64)
    row_of[ids] = np.arange(n)
    # edge list (u -> v): reverse candidate for v is u at the same distance
    src = np.repeat(ids, M)
    dst = fwd_sel.reshape(-1)
    dists = fwd_d.reshape(-1)
    ok = dst >= 0
    src, dst, dists = src[ok], dst[ok], dists[ok]
    rows = row_of[dst]
    order = np.lexsort((src, dists, rows))
    rows, src, dists = rows[order], src[order], dists[order]
    first = np.concatenate([[True], rows[1:] != rows[:-1]])
    gstart = np.maximum.accumulate(np.where(first, np.arange(len(rows)), 0))
    rank = np.arange(len(rows)) - gstart
    # assemble (n, cap_c): forward first, then incoming by rank
    cand = np.full((n, cap_c + M), -1, np.int32)
    cd = np.full((n, cap_c + M), np.inf, np.float32)
    cand[:, :M] = fwd_sel
    cd[:, :M] = fwd_d
    keep = rank < cap_c
    cand[rows[keep], M + rank[keep]] = src[keep]
    cd[rows[keep], M + rank[keep]] = dists[keep]
    # dedup (forward may repeat as incoming) + sort by (dist, id)
    order = np.lexsort((np.where(cand < 0, 2**31 - 1, cand), cd), axis=1)
    cand = np.take_along_axis(cand, order, axis=1)
    cd = np.take_along_axis(cd, order, axis=1)
    dup = np.zeros_like(cand, dtype=bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    cand = np.where(dup, -1, cand)
    cd = np.where(dup, np.inf, cd)
    order = np.lexsort((np.where(cand < 0, 2**31 - 1, cand), cd), axis=1)
    cand = np.take_along_axis(cand, order, axis=1)
    cd = np.take_along_axis(cd, order, axis=1)
    return cand[:, :cap_c], cd[:, :cap_c]


def fast_build_graph(
    vectors: np.ndarray,
    params: HNSWParams | None = None,
    *,
    level_cap: int = 12,
    exact_knn: bool = False,
    mesh=None,
    base_dev=None,
    stage_path: str | None = None,
    pool: int = 0,
) -> GraphSoA:
    """Construct a GraphSoA at scan speed (see module docstring).

    base_dev: an already-device-resident copy of `vectors` (10M-scale
    builds: the layer-0 self-kNN runs as a device sweep with only the
    (n, M) selection leaving the device, and the select stages reuse the
    resident base instead of re-uploading 5 GB per level).

    exact_knn: kNN stages by the exact f32 flat scan instead of the
    class-max scan — bit-identical across mesh layouts (the CPU tests'
    reference build).

    stage_path: mid-build checkpoint (.npz). Layer 0 is ~70-80% of a
    10M-scale build's wall; after layer 0 + connectivity promotion
    the (neighbors0, levels) pair is saved atomically, and a rebuild
    pointed at the same path skips straight to the upper levels. The
    checkpoint is keyed on (n, d, M, M0, metric) and ignored (not
    trusted) on any mismatch. Reference analogue: MN dump/load of the
    built index (SURVEY §5.4) — extended to the build's dominant stage
    because rebuilding is this platform's expensive op.

    pool: candidate-pool width fed to select_heuristic — the
    ef_construction analog. The reference's insert collects an
    efc-wide beam per node (hnsw.hh insert/search_level, efc=500 at its
    published operating point, scripts/config.py:9); this builder feeds
    the EXACT top-`pool` neighbors instead, a strictly stronger pool at
    equal width. 0 keeps the scan-speed default (2*M_out), matching all
    pre-r4 builds; pool=efc is the construction-quality parity setting
    (measured: scripts/scale_1m_hnsw.py efc ladder)."""
    params = params or HNSWParams()
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    metric = params.metric_id
    M, M0 = params.M_max, params.M_max0
    sqn = (vectors * vectors).sum(-1).astype(np.float32)
    if metric != METRIC_L2:
        sqn = np.zeros(n, np.float32)
    vsel, ssel = vectors, sqn
    if base_dev is not None:
        from shine_tpu.models.flat import _row_sq

        vsel = base_dev.astype(jnp.float32)
        # jitted fused norm: the eager square would add a second
        # base-sized buffer (+8.6 GB at 16.78M x 128)
        ssel = (
            _row_sq(vsel)
            if metric == METRIC_L2
            else jnp.zeros(n, jnp.float32)
        )

    levels = np.minimum(draw_levels(n, params), level_cap)
    levels[0] = max(levels[0], levels.max())  # deterministic top at node 0

    import os
    import time as _time

    timing = os.environ.get("SHINE_FASTBUILD_TIMING") == "1"

    def build_level(ids: np.ndarray, m_out: int, cap: int):
        """(adjacency (len(ids), cap) global ids,) for one level."""
        k = min(max(2 * m_out, pool), len(ids) - 1)
        if k <= 0:
            return np.full((len(ids), cap), -1, np.int32)
        t0 = _time.perf_counter()
        if (
            base_dev is not None and len(ids) == n
            and os.environ.get("SHINE_FASTBUILD_HOSTSEL") != "1"
        ):
            # fused device sweep + select: the (n, k+1) kNN table never
            # leaves the device (only the (n, M) selection does) — the
            # path that carries pool=500 at 10M+ (a 42 GB host table
            # otherwise) and the 16.78M M=32 unit
            t1 = t0
            sel, sel_d = _sweep_select_level0(
                base_dev, vsel, ssel, k, m_out, metric,
            )
        else:
            if base_dev is not None and len(ids) == n:
                cand, cd = _knn_device_sweep(base_dev, k, metric)
            else:
                cand, cd = _knn_candidates(vectors, ids, k, metric,
                                           exact_knn, mesh)
            width = max(2 * m_out, pool)
            if cand.shape[1] < width:
                # fixed candidate width across levels -> shared select
                # compiles
                pad = width - cand.shape[1]
                cand = np.pad(cand, ((0, 0), (0, pad)), constant_values=-1)
                cd = np.pad(cd, ((0, 0), (0, pad)), constant_values=np.inf)
            t1 = _time.perf_counter()
            # selection returns its own query distances (no O(n*C*M) host
            # id-matching pass, minutes at 1M rows); reverse capping
            # consumes them directly
            sel, _, sel_d = _device_select(
                vsel, ssel, ids, cand, cd, m_out, metric, with_dists=True
            )
        t2 = _time.perf_counter()
        merged, md = _reverse_merge(sel, sel_d, ids, cap_c=cap + m_out)
        t3 = _time.perf_counter()
        out, n_out = _device_select(
            vsel, ssel, ids, merged, md, cap, metric
        )
        if timing:
            import sys as _sys

            print(
                f"# fastbuild level n={len(ids)}: knn={t1-t0:.2f}s "
                f"select={t2-t1:.2f}s reverse_merge(host)={t3-t2:.2f}s "
                f"select2={_time.perf_counter()-t3:.2f}s",
                file=_sys.stderr, flush=True,
            )
        return out

    # layer 0: all nodes; final lists up to 2M wide (reference M_max0)
    neighbors0 = None
    if stage_path and os.path.exists(stage_path):
        try:
            z = np.load(stage_path)
            key_ok = (
                int(z["n"]) == n and int(z["d"]) == d
                and int(z["M"]) == M and int(z["M0"]) == M0
                and int(z["metric"]) == metric
                and int(z["pool"] if "pool" in z else 0) == pool
            )
            if key_ok:
                neighbors0 = z["neighbors0"]
                levels = z["levels"]  # post-promotion
        except Exception:
            neighbors0 = None  # unreadable/corrupt: rebuild from scratch
    if neighbors0 is None:
        neighbors0 = build_level(np.arange(n, dtype=np.int32), M, M0)

        # connectivity guarantee: every layer-0 component must contain at
        # least one upper-layer vertex, or descent can never reach it (the
        # incremental build gets this for free — early inserts bridge the
        # sparse graph; a pure kNN graph fragments on well-separated
        # clusters). Promote each uncovered component's lowest id to
        # level 1.
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import connected_components

        # neighbors0 is already row-major adjacency: build the CSR
        # directly (indptr from valid-degree cumsum). The COO route
        # (coo_matrix + implicit sort/dedup) takes ~50 min at 10M x 32
        # edges on one core; this is seconds.
        flat = neighbors0.reshape(-1)
        ok = flat >= 0
        deg = ok.reshape(n, -1).sum(axis=1)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        adj = csr_matrix(
            (np.ones(int(indptr[-1]), np.int8), flat[ok].astype(np.int64),
             indptr),
            shape=(n, n),
        )
        n_comp, comp = connected_components(
            adj, directed=True, connection="weak"
        )
        covered = np.zeros(n_comp, bool)
        np.logical_or.at(covered, comp[levels >= 1], True)
        for c in np.where(~covered)[0]:
            rep = int(np.where(comp == c)[0].min())
            levels[rep] = max(levels[rep], 1)

        if stage_path:
            os.makedirs(os.path.dirname(stage_path) or ".", exist_ok=True)
            tmp = stage_path + ".tmp.npz"  # np.savez appends .npz itself
            np.savez(
                tmp, n=n, d=d, M=M, M0=M0, metric=metric, pool=pool,
                levels=levels, neighbors0=neighbors0,
            )
            os.replace(tmp, stage_path)

    top_level = int(levels.max())
    upper_row = np.where(levels > 0, np.cumsum(levels > 0) - 1, -1).astype(
        np.int32
    )
    u_cap = max(int(upper_row.max()) + 1, 1)
    upper_neighbors = np.full((u_cap, max(top_level, 1), M), -1, np.int32)
    for lvl in range(1, top_level + 1):
        ids = np.where(levels >= lvl)[0].astype(np.int32)
        adj = build_level(ids, M, M)
        upper_neighbors[upper_row[ids], lvl - 1] = adj

    cands = np.where(levels == top_level)[0]
    entry_point = int(cands.min())
    return GraphSoA(
        params=params,
        vectors=vectors,
        levels=levels.astype(np.int32),
        neighbors0=neighbors0,
        upper_row=upper_row,
        upper_neighbors=upper_neighbors,
        entry_point=entry_point,
        top_level=top_level,
    )
