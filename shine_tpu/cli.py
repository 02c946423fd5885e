"""Command-line entry point.

The reference's single `shine` binary with boost::program_options flags
(/root/reference/src/main.cc, src/common/configuration.hh:56-113) becomes
`python -m shine_tpu` — one process drives the whole mesh (there is no
CN/MN role split; `--shards` sizes the device mesh). Flag names
follow the reference where the concept carries over:

  --data-path --query-suffix --ip-dist -k -m --ef-construction
  --ef-search --store-index --load-index --no-recall --label --seed
  --cache --cache-ratio --routing

Added here: --index {hnsw,flat,fastflat,ivf,split,routed,auto}, --shards,
--batch, --frontier, --probes, --zipf, --num-queries, --synthetic N:D.

Output: the run's Statistics JSON document on stdout (statistics.hh:14-62
schema) — consumable by scripts/collect_results.py.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="shine_tpu")
    src = p.add_argument_group("dataset")
    src.add_argument("--data-path", help="dataset dir (base.fbin, queries/...)")
    src.add_argument("--synthetic", help="N:D synthetic dataset instead of files")
    src.add_argument("--query-suffix", default="query")
    src.add_argument("--num-queries", type=int, default=0, help="cap query count")
    src.add_argument("--zipf", type=float, default=0.0, help="Zipf alpha workload")
    src.add_argument("--warmup", type=int, default=0, help="warmup queries")
    idx = p.add_argument_group("index")
    idx.add_argument(
        "--index",
        choices=("hnsw", "flat", "fastflat", "ivf", "split", "routed",
                 "auto"),
        default="hnsw",
        help="auto picks the scan family by rows per device: fastflat "
             "while its layout fits the device's memory, then routed "
             "split to 64M rows, then the exact int8 split scan "
             "(config.auto_index_family)",
    )
    idx.add_argument("-m", type=int, default=32, help="HNSW M")
    idx.add_argument("--ef-construction", type=int, default=500)
    idx.add_argument("--ip-dist", action="store_true", help="inner-product metric")
    idx.add_argument("--seed", type=int, default=42)
    idx.add_argument("--store-index", help="path to save the built index")
    idx.add_argument("--load-index", help="path to load a prebuilt index")
    idx.add_argument("--device-build", action="store_true",
                     help="build HNSW on device (batched insert rounds)")
    idx.add_argument("--fast-build", action="store_true",
                     help="build HNSW via the fused kNN scan (fastbuild)")
    q = p.add_argument_group("query")
    q.add_argument("-k", type=int, default=10)
    q.add_argument("--ef-search", type=int, default=128)
    q.add_argument("--frontier", type=int, default=4)
    q.add_argument("--probes", type=int, default=16, help="IVF probes")
    q.add_argument("--ivf-routed", action="store_true",
                   help="IVF tile-shared probing (affinity-sorted tiles "
                        "share a probe union; amortizes the block gather)")
    q.add_argument("--ivf-shared", type=int, default=0,
                   help="probe-union width per tile; 0 = auto (96 for "
                        "--ivf-routed, 12x/6x probes for --index routed)")
    q.add_argument("--ivf-tile", type=int, default=0,
                   help="queries per routed tile; 0 = auto (256 for "
                        "--ivf-routed, the T=32-law rule for "
                        "--index routed)")
    q.add_argument("--batch", type=int, default=2048)
    q.add_argument(
        "--rows", choices=("f32", "bf16", "int8"), default="f32",
        help="HNSW traversal-row storage (quantized at upload — "
        "models/hnsw.py; sharded meshes accept f32|bf16 only)",
    )
    q.add_argument("--prerank", type=int, default=0,
                   help="fastflat/split stage-1 trim width before the "
                        "exact re-rank (0 = off; the trim reuses the "
                        "scan's own scores — ops/distance.py:score_trim)")
    q.add_argument("--megabatch", action="store_true",
                   help="fastflat/split single-chip: fold the whole "
                        "query stream into ONE compiled program "
                        "(lax.map over batches) — kills the per-batch "
                        "launch cost on sustained streams")
    q.add_argument("--exchange", choices=("dense", "compact"),
                   default="dense", help="sharded-HNSW exchange "
                   "pattern (compact = bucketed all_to_all owner RPC)")
    q.add_argument("--adaptive-slack", action="store_true",
                   help="compact exchange: probe the bucket-slack ladder "
                   "on live batches, serve at the measured-min wire bytes")
    q.add_argument("--no-recall", action="store_true")
    run = p.add_argument_group("run")
    run.add_argument("--shards", type=int, default=1, help="device mesh size")
    run.add_argument("--cache", action="store_true", help="hot-vertex replica")
    run.add_argument("--cache-ratio", type=float, default=0.1)
    run.add_argument("--adaptive-cache", action="store_true",
                     help="refresh the hot set from live access counters")
    run.add_argument("--routing", action="store_true", help="affinity routing")
    run.add_argument("--adaptive-routing", action="store_true",
                     help="cross-batch quota feedback (update_limits analogue)")
    run.add_argument("--label", default="")
    return p


def _maybe_force_cpu_mesh() -> None:
    """Honor SHINE_FORCE_CPU_DEVICES=N: run on N virtual CPU devices.

    Sweeps sharded configs without a multi-device machine. Must run
    before the first jax backend touch."""
    import os

    n = os.environ.get("SHINE_FORCE_CPU_DEVICES")
    if not n:
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


def main(argv: list[str] | None = None) -> int:
    from shine_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    _maybe_force_cpu_mesh()
    args = build_parser().parse_args(argv)
    from shine_tpu.config import HNSWParams, SearchParams
    from shine_tpu.io import load_dataset, recall_at_k, synthetic_dataset
    from shine_tpu.io.skew import skewed_workload
    from shine_tpu.utils import SearchStats, Statistics, Timing

    metric = "ip" if args.ip_dist else "l2"
    timing = Timing()

    if args.synthetic:
        n, d = (int(x) for x in args.synthetic.split(":"))
        ds = synthetic_dataset(
            n=n, dim=d, num_queries=max(args.num_queries or 1000, 1),
            metric=metric, seed=args.seed, compute_gt=not args.no_recall,
        )
    elif args.data_path:
        ds = load_dataset(args.data_path, metric=metric, query_suffix=args.query_suffix)
    else:
        print("need --data-path or --synthetic", file=sys.stderr)
        return 2

    queries = ds.queries
    gt = ds.ground_truth  # kept row-aligned with `queries` through reshaping
    if args.num_queries:
        queries = queries[: args.num_queries]
        if gt is not None:
            gt = gt[: args.num_queries]
    warmup_q = None
    if args.zipf > 0 or args.warmup:
        warmup_q, queries, pool_idx = skewed_workload(
            queries, total=len(queries), alpha=args.zipf,
            warmup=args.warmup, seed=args.seed,
        )
        if gt is not None:
            gt = gt[pool_idx]  # ground truth follows the resampled pool rows

    stats = Statistics(
        dataset=ds.name, label=args.label, num_shards=args.shards, zipf=args.zipf
    )
    params = HNSWParams(
        M=args.m, ef_construction=args.ef_construction, metric=metric,
        seed=args.seed,
    )
    sp = SearchParams(k=args.k, ef=args.ef_search, frontier=args.frontier,
                      exchange=args.exchange,
                      adaptive_slack=args.adaptive_slack)
    stats.set_params(params, sp)

    mesh = None
    if args.shards > 1:
        from shine_tpu.parallel import shard_mesh

        mesh = shard_mesh(args.shards)
        if args.megabatch:
            import warnings

            warnings.warn(
                "--megabatch is single-chip only and is ignored with "
                "--shards > 1 (the sharded searcher dispatches per batch)",
                stacklevel=1,
            )

    if args.index == "auto":
        # measured family rule incl. the routed-vs-split crossover —
        # thresholds + rationale live in config.auto_index_family
        from shine_tpu.config import auto_index_family

        rows_per_chip = ds.n / (args.shards if args.shards > 1 else 1)
        args.index = auto_index_family(ds.n, ds.dim, args.shards)
        print(f"# --index auto: {rows_per_chip/1e6:.1f}M rows/chip -> "
              f"{args.index}", file=sys.stderr)

    # ---- build / load ----
    t0 = time.perf_counter()
    searcher, index_bytes, index_obj = _build(args, ds, params, mesh, timing)
    build_s = time.perf_counter() - t0
    stats.set_build(
        num_vectors=ds.n, build_seconds=build_s, index_bytes=index_bytes
    )

    # ---- warmup ----
    if warmup_q is not None and len(warmup_q):
        with timing.measure("warmup"):
            if hasattr(index_obj, "warm"):
                # full warmup pass: heats the access counters and adapts
                # the hot set before the timed run (compute_node.cc:116-131)
                index_obj.warm(warmup_q, sp, batch_size=args.batch)
            else:
                searcher(warmup_q[: args.batch])

    # ---- timed queries ----
    s = SearchStats()
    searcher(queries[: args.batch])  # compile
    with timing.measure("query"):
        t0 = time.perf_counter()
        ids = searcher(queries)
        s.add_batch(
            len(queries), hops_sum=0, steps=0, cand_lanes=0, row_bytes=0,
            seconds=time.perf_counter() - t0,
        )
    if not args.no_recall and gt is not None:
        s.recall = recall_at_k(ids, gt, args.k)
    s.expansions = getattr(index_obj, "last_hops", 0)
    if s.expansions:
        # exact per-computation count from the traversal loop (valid
        # candidate lanes actually scored — statistics.hh:152-158); the
        # sharded path keeps the hops*M_max0 estimate (last_dists = 0)
        s.distance_computations = (
            getattr(index_obj, "last_dists", 0)
            or s.expansions * params.M_max0
        )
        s.hbm_gather_bytes = s.distance_computations * 4 * (ds.dim + 1)
    elif hasattr(index_obj, "cost_counters"):
        # dense-scan families: costs are analytic in the shapes
        # (statistics.hh:122-141 reports them for every run)
        if args.index == "ivf" and args.ivf_routed:
            cc = index_obj.routed_cost_counters(
                len(queries), args.k, probes=args.probes,
                shared=args.ivf_shared or 96, tile=args.ivf_tile or 256,
            )
        else:
            kw = {"batch_size": args.batch}
            if args.index == "ivf":
                kw["probes"] = args.probes
            elif args.index == "routed":
                kw = {"probes": args.probes, "shared": args.ivf_shared,
                      "tile": args.ivf_tile}
            cc = index_obj.cost_counters(len(queries), args.k, **kw)
        s.distance_computations = cc["distance_computations"]
        s.scanned_rows = cc["scanned_rows"]
        s.hbm_gather_bytes = cc["hbm_gather_bytes"]
        s.ici_exchange_bytes = cc["ici_exchange_bytes"]
    if getattr(index_obj, "ici_bytes", 0):
        # measured on device (parallel/sharded.py state counter) — covers
        # the sharded HNSW path in both exchange modes
        s.ici_exchange_bytes = int(index_obj.ici_bytes)
    s.cache_hits = getattr(index_obj, "cache_hits", 0)
    s.cache_misses = getattr(index_obj, "cache_misses", 0)
    stats.set_queries(s)
    stats.timings = timing.as_dict()
    print(stats.dumps())
    return 0


def _build(args, ds, params, mesh, timing):
    """Returns (searcher(queries) -> ids, index_size_bytes, index_obj)."""
    from shine_tpu.config import SearchParams

    sp = SearchParams(k=args.k, ef=args.ef_search, frontier=args.frontier,
                      exchange=args.exchange,
                      adaptive_slack=args.adaptive_slack)
    if args.index == "flat":
        if mesh is not None:
            from shine_tpu.parallel import ShardedFlatIndex

            idx = ShardedFlatIndex(ds.base, mesh, metric=params.metric)
        else:
            from shine_tpu.models.flat import FlatIndex

            idx = FlatIndex(ds.base, metric=params.metric)
        return (
            lambda q: idx.search(q, args.k, batch_size=args.batch)[0],
            ds.base.nbytes,
            idx,
        )
    if args.index == "fastflat":
        if mesh is not None:
            from shine_tpu.parallel import ShardedFastFlatIndex

            idx = ShardedFastFlatIndex(ds.base, mesh, metric=params.metric)
        else:
            from shine_tpu.models.flat import FastFlatIndex

            idx = FastFlatIndex(ds.base, metric=params.metric)
        kw = {} if mesh is not None else {"megabatch": args.megabatch}
        return (
            lambda q: idx.search(q, args.k, batch_size=args.batch,
                                 prerank=args.prerank, **kw)[0],
            ds.base.nbytes,
            idx,
        )
    if args.index == "split":
        # int8 split CAPACITY layout (136 B/row at d=128): the one-chip
        # 100M-class exact configuration (models/flat.py:SplitFlatIndex);
        # with --shards the table row-shards over the mesh (the
        # 0.8B-class configuration, parallel/fastflat_sharded.py)
        if mesh is not None:
            from shine_tpu.parallel.fastflat_sharded import (
                ShardedSplitFlatIndex,
            )

            idx = ShardedSplitFlatIndex.from_host(
                ds.base, mesh, metric=params.metric, comp_dtype="int8",
                seed=args.seed,
            )
        else:
            from shine_tpu.models.flat import SplitFlatIndex

            idx = SplitFlatIndex(
                ds.base, metric=params.metric, comp_dtype="int8",
                seed=args.seed,
            )
        kw = {} if mesh is not None else {"megabatch": args.megabatch}
        return (
            lambda q: idx.search(q, args.k, batch_size=args.batch,
                                 prerank=args.prerank, **kw)[0],
            idx.comp.nbytes + idx.aux.nbytes,
            idx,
        )
    if args.index == "routed":
        # cluster-pruned serving over the split tables
        # (models/routed_split.py); --probes/--ivf-shared/--ivf-tile
        # map to (probes, shared, tile). With --shards the cluster
        # blocks deal round-robin onto the mesh and the exact re-rank
        # runs replicated from the host base
        # (parallel/routed_sharded.py host-base mode)
        import jax.numpy as jnp
        import numpy as np

        from shine_tpu.models.routed_split import build_routed_split

        base_dev = jnp.asarray(
            np.ascontiguousarray(ds.base, dtype=np.float32)
        )
        idx = build_routed_split(
            ds.n, ds.base.shape[1], base_dev=base_dev,
            metric=params.metric, seed=args.seed,
            shards=args.shards if mesh is not None else 1,
        )
        nbytes = idx.comp.nbytes + idx.aux_r.nbytes + idx.gid.nbytes
        if mesh is not None:
            from shine_tpu.parallel.routed_sharded import (
                ShardedRoutedSplitIndex,
            )

            idx = ShardedRoutedSplitIndex.from_single(idx, mesh)
        # --ivf-tile 0 (the parser default) = the search's own auto
        # rule (the T=32 law); any explicit value passes through
        return (
            lambda q: idx.search(
                q, args.k, probes=args.probes, shared=args.ivf_shared,
                tile=args.ivf_tile, batch_size=args.batch,
            )[0],
            nbytes,
            idx,
        )
    if args.index == "ivf":
        if mesh is not None:
            from shine_tpu.parallel import ShardedIVFIndex

            idx = ShardedIVFIndex(ds.base, mesh, metric=params.metric, seed=args.seed)
        else:
            from shine_tpu.models.ivf import IVFIndex

            idx = IVFIndex(ds.base, metric=params.metric, seed=args.seed)
        if args.ivf_routed:
            # both IVFIndex and ShardedIVFIndex expose search_routed
            return (
                lambda q: idx.search_routed(
                    q, args.k, probes=args.probes,
                    shared=args.ivf_shared or 96,
                    tile=args.ivf_tile or 256,
                )[0],
                ds.base.nbytes * 2,
                idx,
            )
        return (
            lambda q: idx.search(q, args.k, probes=args.probes, batch_size=args.batch)[0],
            ds.base.nbytes * 2,
            idx,
        )
    # hnsw
    from shine_tpu.graph import build_graph
    from shine_tpu.io import load_graph, save_graph

    if args.load_index:
        with timing.measure("load_index_buffer"):
            graph = load_graph(args.load_index)
    elif args.device_build:
        from shine_tpu.models import device_build_graph

        graph = device_build_graph(ds.base, params, mesh=mesh)
    elif args.fast_build:
        from shine_tpu.models.fastbuild import fast_build_graph

        # when the built index will be stored anyway, also stage-checkpoint
        # layer 0 next to it so a mid-build crash resumes (fastbuild
        # stage_path docstring)
        stage = (
            args.store_index + ".stage0.npz" if args.store_index else None
        )
        graph = fast_build_graph(ds.base, params, mesh=mesh,
                                 stage_path=stage)
    else:
        graph = build_graph(ds.base, params)
    if args.store_index:
        with timing.measure("store_index_buffer"):
            save_graph(graph, args.store_index)
    nbytes = sum(
        a.nbytes
        for a in (graph.vectors, graph.levels, graph.neighbors0,
                  graph.upper_row, graph.upper_neighbors)
    )
    if mesh is not None:
        from shine_tpu.parallel import ShardedIndex

        cache_cap = (
            int(args.cache_ratio * ds.n) if args.cache else 0
        )  # --cache-ratio of the node count, cf. reference cache sizing
        # (compute_node.cc:43-56)
        idx = ShardedIndex(
            graph, mesh, cache_capacity=cache_cap,
            routing="adaptive" if args.adaptive_routing else args.routing,
            adaptive_cache=args.adaptive_cache and cache_cap > 0,
            rows=args.rows,  # int8 raises: sharded path is f32|bf16 only
        )
    else:
        from shine_tpu.models import HNSWIndex

        idx = HNSWIndex(graph, rows=args.rows)
    return lambda q: idx.search(q, sp, batch_size=args.batch)[0], nbytes, idx


if __name__ == "__main__":
    raise SystemExit(main())
