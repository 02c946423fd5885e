#!/usr/bin/env python
"""Interconnect wire-cost experiment: dense vs compact exchange x routing x cache
x Zipf skew, on the virtual CPU mesh.

The reference's skew experiment (exp_cache_size_and_skew.py) charts
cache hit rate; on a device mesh the analogous currency is interconnect bytes per
query — replica hits and affinity-routed locality keep lanes on the
all_to_all diagonal, which never crosses the wire. Uses the measured
device-side counters (parallel/sharded.py: ici_bytes/ici_lanes/
rpc_rounds), not analytic formulas.

Usage: SHINE_FORCE_CPU_DEVICES=8 python scripts/exp_ici_exchange.py
Appends rows to results/ici_exchange.csv.
"""

from __future__ import annotations

import csv
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

os.environ.setdefault("SHINE_FORCE_CPU_DEVICES", "8")
from shine_tpu.cli import _maybe_force_cpu_mesh  # noqa: E402

_maybe_force_cpu_mesh()

from shine_tpu.config import HNSWParams, SearchParams  # noqa: E402
from shine_tpu.graph import build_graph  # noqa: E402
from shine_tpu.io import recall_at_k, synthetic_dataset  # noqa: E402
from shine_tpu.io.skew import skewed_workload  # noqa: E402
from shine_tpu.parallel import ShardedIndex, shard_mesh  # noqa: E402

N, D, NQ = 20_000, 32, 2048
OUT = os.path.join(ROOT, "results", "ici_exchange.csv")


def main() -> None:
    ds = synthetic_dataset(n=N, dim=D, num_queries=1024, seed=7, gt_k=10)
    graph = build_graph(ds.base, HNSWParams(M=16, ef_construction=100),
                        threads=8)
    mesh = shard_mesh(8)
    rows = []
    for alpha in (0.0, 1.25):
        _, q, pool_idx = skewed_workload(
            ds.queries, total=NQ, alpha=alpha, warmup=0, seed=3
        )
        gt = ds.ground_truth[pool_idx]
        for exchange, adaptive in (
            ("dense", False), ("compact", False), ("compact", True)
        ):
            for routing, cache_ratio in (
                (None, 0.0),
                (None, 0.15),
                ("static", 0.15),
            ):
                idx = ShardedIndex(
                    graph, mesh,
                    cache_capacity=int(cache_ratio * N),
                    routing=routing or False,
                )
                sp = SearchParams(k=10, ef=64, exchange=exchange,
                                  adaptive_slack=adaptive)
                ids, _ = idx.search(q, sp, batch_size=256)
                r = recall_at_k(ids, gt, 10)
                tot = idx.cache_hits + idx.cache_misses
                row = {
                    "exchange": exchange + ("+adaptive" if adaptive else ""),
                    "routing": routing or "none",
                    "cache_ratio": cache_ratio,
                    "zipf": alpha,
                    "recall": round(float(r), 4),
                    "ici_bytes_per_q": round(idx.ici_bytes / NQ, 1),
                    "ici_lanes_per_q": round(idx.ici_lanes / NQ, 2),
                    "rpc_rounds": idx.rpc_rounds,
                    "cache_hit_rate": round(
                        idx.cache_hits / tot, 4) if tot else 0.0,
                }
                rows.append(row)
                print("#", row, flush=True)
    new = not os.path.exists(OUT)
    with open(OUT, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        if new:
            w.writeheader()
        w.writerows(rows)
    print(f"# wrote {len(rows)} rows -> {OUT}")


if __name__ == "__main__":
    main()
