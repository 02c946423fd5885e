"""Smoke run of the serving and build path on NVIDIA GPUs.

    python chip_smoke.py            # one card: phases A-D
    python chip_smoke.py --multi    # four cards: sharded vs single card

Drives the package's public index classes at full width in SIFT/DEEP-like
shapes (128-d f32, L2, k=10, 10,000 queries; data generated on the card
from --seed) and checks each phase against the plain reference, an f32
brute force at HIGHEST precision, itself cross-checked in float64 numpy
on a 1,000-query subset:

  A fastflat  10M rows  FastFlatIndex.from_device at its auto knobs,
                        searched through FastFlatIndex.search; then the
                        Triton class-max kernel and the XLA engine timed
                        in turns over the whole table and compared
  B hnsw       1M rows  fast_build_graph M=16 efc=200, HNSWIndex ef 64/128
  C split      1M rows  SplitFlatIndex, int8 components
  D routed     1M rows  build_routed_split + search; IVFIndex

--multi runs only the four-card comparisons: ShardedIndex (dense and
compact exchange) over a 1M graph built in the call against HNSWIndex on
one card, and ShardedFastFlatIndex 4-way at 10M rows against
FastFlatIndex.

Every line before the last is a human-readable record (card, versions,
one JSON object per phase). A failed phase or a missed floor exits
non-zero, and only a clean run prints the last line,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import numpy as np

K = 10
DIM = 128
NUM_QUERIES = 10_000
CROSSCHECK_QUERIES = 1_000
ROWS_A = 10_000_000
ROWS_BCD = 1_000_000
FLOORS = {
    "fastflat_eps": 0.99,
    "hnsw_ef128": 0.95,
    "split": 0.99,
    "routed": 0.90,
    "ivf": 0.90,
    "gt_f64": 0.999,
    "scan_rows_same": 0.999,
    "multi_ids_same": 0.999,
}


def log(tag: str, **fields) -> None:
    print(f"{tag} {json.dumps(fields, default=float)}", flush=True)


def check(name: str, value: float, floor: float) -> None:
    if not value >= floor:
        raise RuntimeError(f"{name} = {value} below its floor {floor}")


def card_line() -> str:
    """Name and power limit of the cards, from nvidia-smi (a child
    process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def timed(fn):
    """(result, seconds) of fn(), synced with block_until_ready. Timed
    searches follow an untimed warm-up over the same query set: the
    search programs take the whole padded query array, so a warm-up on
    fewer queries would leave a compile inside the timed window."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def compile_report(jitted, *args, **kwargs):
    """AOT-compile one search step: (compiled, seconds, memory fields)."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **kwargs).compile()
    secs = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    fields = {
        f: int(getattr(mem, f)) for f in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes",
        )
    } if mem is not None else {}
    return compiled, secs, fields


def make_dataset(n: int, nq: int, seed: int):
    """Device-generated mixture-of-Gaussians base with exact f32 ground
    truth (io/device_synth.py; FlatIndex at HIGHEST precision)."""
    from shine_tpu.io.device_synth import device_synthetic_dataset

    ds, secs = timed(lambda: device_synthetic_dataset(
        n=n, dim=DIM, num_queries=nq, seed=seed, gt_k=K,
    ))
    log("dataset", rows=ds.n, dims=DIM, queries=nq, seed=seed,
        generate_and_gt_s=secs)
    return ds


def crosscheck_gt(ds, n_eval: int = CROSSCHECK_QUERIES,
                  chunk: int = 1 << 18) -> float:
    """Share of queries whose device ground truth is exact in float64:
    its ids' f64 distances are non-decreasing and no row of the base is
    closer than its 10th neighbour, both up to 1e-5 relative (the f32
    expansion |q|^2 - 2<q,v> + |v|^2 carries ~1e-6 relative error, so
    closer near-ties are not decidable in f32). One f64 GEMM per chunk
    scores [q, 1] . [-2v, |v|^2] against each query's threshold minus
    |q|^2; nothing is sorted."""
    q = np.asarray(ds.queries[:n_eval], np.float64)
    gt = np.asarray(ds.ground_truth[:n_eval, :K])
    n_eval = len(q)
    base = np.asarray(ds.base_dev)  # one f32 download
    rows = base[gt.reshape(-1)].astype(np.float64).reshape(n_eval, K, -1)
    d_gt = ((rows - q[:, None, :]) ** 2).sum(-1)
    # closer than the 10th  <=>  -2<q,v> + |v|^2 < thresh - |q|^2
    limit = d_gt[:, K - 1] * (1 - 1e-5) - (q * q).sum(1)
    q1 = np.concatenate([q, np.ones((n_eval, 1))], axis=1)
    closer = np.zeros(n_eval, np.int64)
    for lo in range(0, len(base), chunk):
        v = base[lo: lo + chunk].astype(np.float64)
        vx = np.concatenate([-2.0 * v, (v * v).sum(1, keepdims=True)], 1)
        closer += np.count_nonzero(q1 @ vx.T < limit[:, None], axis=1)
    ordered = (np.diff(d_gt, axis=1) >= -1e-5 * d_gt[:, 1:]).all(1)
    ok = (closer <= K - 1) & ordered
    share = float(ok.mean())
    log("gt_crosscheck", queries=n_eval, f64_exact_share=share)
    check("gt_crosscheck f64_exact_share", share, FLOORS["gt_f64"])
    return share


def recall_fields(ids, ds, *, eps: bool = False) -> dict:
    from shine_tpu.io.recall import recall_at_k, recall_at_k_eps

    out = {"recall": recall_at_k(ids, ds.ground_truth, K)}
    if eps:
        out["recall_eps"] = recall_at_k_eps(
            ids, ds.queries, ds.base_dev, ds.ground_truth, K, rtol=1e-4
        )
    return out


def scan_agreement(ext, q_ext, *, cls: int, keep2: bool, reps: int = 2,
                   interpret: bool = False) -> dict:
    """The Triton class-max kernel against the XLA engine on one query
    batch over the whole table: each timed in turns (kernel, XLA, XLA,
    kernel, ...; median ms after a warm-up), class maxima within
    1e-3 x max|score| (f32 accumulation order differs), and the share of
    identical class rows."""
    from shine_tpu.ops.classmax import classmax_xla
    from shine_tpu.ops.classmax_triton import classmax_triton

    engines = {
        "triton": lambda: classmax_triton(ext, q_ext, cls=cls, keep2=keep2,
                                          interpret=interpret),
        "xla": lambda: classmax_xla(ext, q_ext, cls=cls, keep2=keep2),
    }
    outs = {e: timed(fn)[0] for e, fn in engines.items()}  # compile
    walls = {e: [] for e in engines}
    for _ in range(reps):
        for e in ("triton", "xla", "xla", "triton"):
            walls[e].append(timed(engines[e])[1])
    a, b = outs["triton"], outs["xla"]
    ma, mb = np.asarray(a[0]), np.asarray(b[0])
    out = {
        "keep2": keep2, "rows": int(ext.shape[0]), "width": int(ext.shape[1]),
        "queries": int(q_ext.shape[0]), "cls": cls,
        "ms": {e: 1e3 * float(np.median(w)) for e, w in walls.items()},
        "max_abs_diff": float(np.abs(ma - mb).max()),
        "tol": float(1e-3 * np.abs(mb).max()),
        "rows_same": float((np.asarray(a[1]) == np.asarray(b[1])).mean()),
    }
    log("scan_engines", **out)
    if not out["max_abs_diff"] <= out["tol"]:
        raise RuntimeError(f"class maxima disagree: {out}")
    check("scan rows_same", out["rows_same"], FLOORS["scan_rows_same"])
    return out


def phase_fastflat(ds, *, batch: int = 4096, reps: int = 3,
                   interpret: bool = False) -> dict:
    """Phase A: FastFlatIndex.from_device at its auto knobs, searched
    through FastFlatIndex.search (the CLI's path, on the engine
    ops/classmax.scan_engine picks). Then the class-max kernel against
    the XLA engine at the table's full size, keep1 and keep2."""
    import jax.numpy as jnp

    from shine_tpu.models.flat import FastFlatIndex, fast_flat_search_at
    from shine_tpu.ops.classmax import scan_engine
    from shine_tpu.ops.packing import pack_ext_query

    idx, build_s = timed(lambda: FastFlatIndex.from_device(ds.base_dev))
    kb, cls, keep2 = idx._resolve_knobs(0, 0, None)
    q_dev, nq = idx.preload(ds.queries, batch_size=batch)
    _, compile_s, mem = compile_report(
        fast_flat_search_at, idx.ext, idx.vectors, idx.sqnorms, q_dev, 0,
        k=K, kb=kb, cls=cls, metric=idx.metric, batch=batch, keep2=keep2,
        n=idx.n, row_source=None,
    )
    log("memory_analysis", phase="fastflat", **mem)
    search = lambda: idx.search(ds.queries, K, batch_size=batch)  # noqa: E731
    search()  # warm-up
    walls = []
    for _ in range(reps):
        (ids, _), secs = timed(search)
        walls.append(secs)
    rec = recall_fields(ids, ds, eps=True)
    search_s = float(np.median(walls))
    res = {
        "rows": idx.n, "dims": idx.dim, "kb": kb, "cls": cls, "keep2": keep2,
        "engine": scan_engine(), "build_s": build_s, "compile_s": compile_s,
        "search_s": search_s, "search_all_s": walls, "qps": nq / search_s,
        **rec, "peak_bytes_in_use": peak_bytes(),
    }
    log("phase", name="A_fastflat", **res)
    check("fastflat recall_eps", rec["recall_eps"], FLOORS["fastflat_eps"])
    q_ext = pack_ext_query(q_dev[:batch], idx.ext.shape[1])
    res["scan"] = [
        scan_agreement(idx.ext, q_ext.astype(jnp.bfloat16), cls=cls,
                       keep2=k2, interpret=interpret)
        for k2 in (False, True)
    ]
    return res


def phase_hnsw(ds, *, M: int = 16, efc: int = 200, efs=(64, 128),
               batch: int = 1024):
    """Phase B: the CLI's --fast-build path, then HNSWIndex at each ef.
    Returns (result, graph)."""
    from shine_tpu.config import HNSWParams, SearchParams
    from shine_tpu.models import HNSWIndex
    from shine_tpu.models.fastbuild import fast_build_graph
    from shine_tpu.models.hnsw import batched_search

    base = np.asarray(ds.base_dev)
    params = HNSWParams(M=M, ef_construction=efc)
    graph, build_s = timed(lambda: fast_build_graph(base, params))
    idx, upload_s = timed(lambda: HNSWIndex(graph))
    res = {"rows": len(base), "dims": base.shape[1], "M": M, "efc": efc,
           "build_s": build_s, "upload_s": upload_s, "ef": {}}
    for ef in efs:
        sp = SearchParams(k=K, ef=ef)
        q0 = np.asarray(ds.queries[:batch], np.float32)
        _, compile_s, mem = compile_report(
            batched_search, idx.device, q0, top_level=idx.top_level,
            search_params=sp.resolved(), metric=idx.metric,
            with_stats=True, nbr_width=idx.nbr_width,
        )
        log("memory_analysis", phase="hnsw", ef=ef, **mem)
        idx.search(ds.queries, sp, batch_size=batch)  # warm-up
        (ids, _), secs = timed(
            lambda: idx.search(ds.queries, sp, batch_size=batch)
        )
        res["ef"][ef] = {
            "compile_s": compile_s, "search_s": secs,
            "qps": len(ds.queries) / secs, **recall_fields(ids, ds),
            "hops_per_query": idx.last_hops / len(ds.queries),
        }
    res["peak_bytes_in_use"] = peak_bytes()
    log("phase", name="B_hnsw", **res)
    check("hnsw recall@ef=max", res["ef"][max(efs)]["recall"],
          FLOORS["hnsw_ef128"])
    return res, graph


def phase_split(ds, *, batch: int = 4096) -> dict:
    """Phase C: SplitFlatIndex with int8 components on the XLA engine."""
    from shine_tpu.models.flat import SplitFlatIndex, split_flat_search_mega

    idx, build_s = timed(
        lambda: SplitFlatIndex.from_device(ds.base_dev, comp_dtype="int8")
    )
    kb, cls, keep2 = idx._resolve_knobs(0, 0, None)
    q_dev, _ = idx.preload(ds.queries, batch_size=batch)
    _, compile_s, mem = compile_report(
        split_flat_search_mega, idx.comp, idx.aux, idx.vectors,
        idx.sqnorms, q_dev, row_source=None, k=K, kb=kb, cls=cls,
        metric=idx.metric, batch=batch, keep2=keep2, n=idx.n, prerank=0,
    )
    log("memory_analysis", phase="split", **mem)
    search = lambda: idx.search(ds.queries, K, batch_size=batch,  # noqa: E731
                                preloaded=(q_dev, len(ds.queries)),
                                megabatch=True)
    search()  # warm-up
    (ids, _), secs = timed(search)
    res = {"rows": idx.n, "dims": idx.dim, "comp": "int8", "kb": kb,
           "cls": cls, "keep2": keep2, "build_s": build_s,
           "compile_s": compile_s, "search_s": secs,
           "qps": len(ds.queries) / secs, **recall_fields(ids, ds),
           "peak_bytes_in_use": peak_bytes()}
    log("phase", name="C_split", **res)
    check("split recall", res["recall"], FLOORS["split"])
    return res


def phase_routed_ivf(ds, *, batch: int = 2048, ivf_probes: int = 128) -> dict:
    """Phase D: routed split at its auto knobs, and IVFIndex on its
    default fine layout (~128 rows per cluster). IVF has no automatic
    probe count: 128 of the 7,813 clusters at 1M rows is the share of
    clusters (1.6%) that held recall 0.993 at 262k rows on CPU."""
    import jax.numpy as jnp

    from shine_tpu.models.ivf import IVFIndex, ivf_search
    from shine_tpu.models.routed_split import build_routed_split

    ridx, rbuild_s = timed(lambda: build_routed_split(
        ds.n, DIM, base_dev=ds.base_dev, seed=1,
    ))
    ridx.search(ds.queries, K, batch_size=batch)  # warm-up
    (rids, _), rsecs = timed(
        lambda: ridx.search(ds.queries, K, batch_size=batch)
    )
    routed = {"clusters": ridx.C, "cap": ridx.cap, "build_s": rbuild_s,
              "search_s": rsecs, "qps": len(ds.queries) / rsecs,
              "coverage": ridx.last_coverage,
              "fallback_queries": ridx.last_fallback,
              **recall_fields(rids, ds)}
    del ridx
    gc.collect()
    iidx, ibuild_s = timed(lambda: IVFIndex.from_device(ds.base_dev))
    q0 = jnp.asarray(np.asarray(ds.queries[:batch], np.float32))
    p = min(ivf_probes, iidx.data.num_clusters)
    _, icompile_s, mem = compile_report(
        ivf_search, iidx.data, q0, k=K, p=p, metric=iidx.metric, rerank=4,
        approx_probes=False,
    )
    log("memory_analysis", phase="ivf", **mem)
    iidx.search(ds.queries, K, probes=p, batch_size=batch)  # warm-up
    (iids, _), isecs = timed(
        lambda: iidx.search(ds.queries, K, probes=p, batch_size=batch)
    )
    ivf = {"clusters": iidx.data.num_clusters, "probes": p,
           "build_s": ibuild_s, "compile_s": icompile_s, "search_s": isecs,
           "qps": len(ds.queries) / isecs, **recall_fields(iids, ds)}
    res = {"rows": ds.n, "dims": DIM, "routed": routed, "ivf": ivf,
           "peak_bytes_in_use": peak_bytes()}
    log("phase", name="D_routed_ivf", **res)
    check("routed recall", routed["recall"], FLOORS["routed"])
    check("ivf recall", ivf["recall"], FLOORS["ivf"])
    return res


def devices_holding(arr) -> dict:
    """Bytes of `arr` held on each device: shards on the whole mesh, not
    all on device 0."""
    held: dict = {}
    for shard in arr.addressable_shards:
        key = str(shard.device.id)
        held[key] = held.get(key, 0) + int(shard.data.nbytes)
    return held


def ids_same(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).mean())


def multi_hnsw(ds, mesh, *, M: int = 16, efc: int = 200, ef: int = 128,
               batch: int = 1024) -> dict:
    """ShardedIndex over the mesh (dense and compact exchange) against
    HNSWIndex on one card, on a graph built in this call."""
    from shine_tpu.config import HNSWParams, SearchParams
    from shine_tpu.models import HNSWIndex
    from shine_tpu.models.fastbuild import fast_build_graph
    from shine_tpu.parallel import ShardedIndex

    base = np.asarray(ds.base_dev)
    graph, build_s = timed(lambda: fast_build_graph(
        base, HNSWParams(M=M, ef_construction=efc), mesh=mesh,
    ))
    res = {"rows": len(base), "M": M, "ef": ef, "build_s": build_s}
    single = HNSWIndex(graph)
    res["single_devices"] = devices_holding(single.device.vectors_ext)
    sp = SearchParams(k=K, ef=ef)
    single.search(ds.queries, sp, batch_size=batch)  # warm-up
    (ref, _), secs = timed(lambda: single.search(ds.queries, sp,
                                                 batch_size=batch))
    res["single"] = {"search_s": secs, **recall_fields(ref, ds)}
    sharded = ShardedIndex(graph, mesh)
    res["sharded_devices"] = devices_holding(sharded.device.vectors)
    for exchange in ("dense", "compact"):
        spx = SearchParams(k=K, ef=ef, exchange=exchange)
        sharded.search(ds.queries, spx, batch_size=batch)  # warm-up
        (ids, _), secs = timed(lambda: sharded.search(ds.queries, spx,
                                                      batch_size=batch))
        res[exchange] = {"search_s": secs, "ids_same": ids_same(ids, ref),
                         **recall_fields(ids, ds)}
    log("phase", name="multi_hnsw", **res)
    if len(res["sharded_devices"]) != mesh.devices.size:
        raise RuntimeError(f"graph shards on {res['sharded_devices']}")
    for exchange in ("dense", "compact"):
        check(f"multi hnsw {exchange} ids_same", res[exchange]["ids_same"],
              FLOORS["multi_ids_same"])
    return res


def multi_fastflat(ds, mesh, *, kb: int = 128, cls: int = 2048,
                   batch: int = 4096) -> dict:
    """ShardedFastFlatIndex over the mesh against FastFlatIndex on one
    card. Both keep the runner-up with a wide candidate margin, so each
    returns the exact top-10 and the ids can be compared one to one."""
    from shine_tpu.models.flat import FastFlatIndex
    from shine_tpu.parallel import ShardedFastFlatIndex

    base = np.asarray(ds.base_dev)
    kw = dict(kb=kb, cls=cls, keep2=True, batch_size=batch)
    single, build1 = timed(lambda: FastFlatIndex(base))
    single.search(ds.queries, K, **kw)  # warm-up
    (ref, _), secs1 = timed(lambda: single.search(ds.queries, K, **kw))
    del single
    gc.collect()
    sharded, build4 = timed(lambda: ShardedFastFlatIndex(base, mesh))
    placed = devices_holding(sharded.ext)
    sharded.search(ds.queries, K, **kw)  # warm-up
    (ids, _), secs4 = timed(lambda: sharded.search(ds.queries, K, **kw))
    res = {"rows": len(base), "shards": mesh.devices.size, "kb": kb,
           "cls": cls, "single": {"build_s": build1, "search_s": secs1,
                                  **recall_fields(ref, ds)},
           "sharded": {"build_s": build4, "search_s": secs4,
                       "devices": placed, **recall_fields(ids, ds)},
           "ids_same": ids_same(ids, ref)}
    log("phase", name="multi_fastflat", **res)
    if len(placed) != mesh.devices.size:
        raise RuntimeError(f"table shards on {placed}")
    check("multi fastflat ids_same", res["ids_same"],
          FLOORS["multi_ids_same"])
    return res


def run_single(seed: int) -> None:
    ds = make_dataset(ROWS_A, NUM_QUERIES, seed)
    crosscheck_gt(ds)
    t0 = time.perf_counter()
    phase_fastflat(ds)
    log("wall", phase="A_fastflat", seconds=time.perf_counter() - t0)
    del ds
    gc.collect()
    ds = make_dataset(ROWS_BCD, NUM_QUERIES, seed + 1)
    crosscheck_gt(ds)
    for name, fn in (("B_hnsw", phase_hnsw), ("C_split", phase_split),
                     ("D_routed_ivf", phase_routed_ivf)):
        t0 = time.perf_counter()
        fn(ds)
        log("wall", phase=name, seconds=time.perf_counter() - t0)
        gc.collect()


def run_multi(seed: int, n_cards: int) -> None:
    from shine_tpu.parallel import shard_mesh

    mesh = shard_mesh(n_cards)
    ds = make_dataset(ROWS_BCD, NUM_QUERIES, seed + 1)
    t0 = time.perf_counter()
    multi_hnsw(ds, mesh)
    log("wall", phase="multi_hnsw", seconds=time.perf_counter() - t0)
    del ds
    gc.collect()
    ds = make_dataset(ROWS_A, NUM_QUERIES, seed)
    t0 = time.perf_counter()
    multi_fastflat(ds, mesh)
    log("wall", phase="multi_fastflat", seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: sharded paths against one card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n_cards = 4 if args.multi else 1

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    if len(devices) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2

    from shine_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(card_line(), flush=True)
    log("versions", jax=jax.__version__, device_kind=devices[0].device_kind,
        devices=len(devices))
    t0 = time.perf_counter()
    if args.multi:
        run_multi(args.seed, n_cards)
    else:
        run_single(args.seed)
    log("wall", phase="total", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
