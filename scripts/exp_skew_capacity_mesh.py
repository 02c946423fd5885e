#!/usr/bin/env python
"""Skew x budget grid for the SHARDED capacity family on the CPU mesh.

The mesh leg of the reference's cache-size-and-skew experiment
(/root/reference/scripts/exp_cache_size_and_skew.py) for the
cluster-sharded routed-split path: Zipf(alpha) resampling concentrates
the query stream on popular queries, which concentrates probe grants on
the shards owning the hot clusters; the owned-lane budget P_loc is the
per-shard serving resource (the cache-ratio analog). QPS on virtual CPU
devices is meaningless — the DEVICE-MEASURED counters (owned-lane
occupancy, overflow drops, coverage) plus recall are the platform-
independent result, like results/routed_sharded_counters.jsonl.

Appends results/skew_capacity_mesh.jsonl + writes skew_capacity_mesh.csv.
"""

from __future__ import annotations

import csv
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

OUT = os.path.join(ROOT, "results", "skew_capacity_mesh.jsonl")
CSV = OUT.replace(".jsonl", ".csv")

ALPHAS = [0.0, 0.75, 1.25]
P_LOCS = [32, 12, 6]


def emit(rec: dict) -> None:
    print("#", json.dumps(rec), flush=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(rec) + "\n")


def main() -> None:
    from shine_tpu.io import recall_at_k
    from shine_tpu.io.device_synth import regen_rows
    from shine_tpu.io.skew import zipf_ranks
    from shine_tpu.parallel.mesh import shard_mesh
    from shine_tpu.parallel.routed_sharded import build_routed_split_sharded

    n, d, npool, stream = 65_536, 32, 256, 512
    key = jax.random.PRNGKey(21)
    centers = jax.random.normal(jax.random.PRNGKey(22), (32, d)) * 4.0
    rng = np.random.default_rng(23)
    anchors = np.asarray(
        regen_rows(key, centers, jnp.asarray(
            rng.integers(0, n, npool), dtype=jnp.int32))
    )
    pool = anchors + rng.normal(size=(npool, d)).astype(np.float32) * 0.3

    mesh = shard_mesh(8)
    idx, gt = build_routed_split_sharded(
        n, d, mesh, row_source=(key, centers), cap_target=1024, cls=256,
        train_size=65_536, seed=24, queries=pool,
        log=lambda m: print(m, flush=True),
    )
    p, P, T = 16, 32, 32
    rows = []
    for alpha in ALPHAS:
        perm = np.random.default_rng(31).permutation(npool)
        sel = perm[zipf_ranks(npool, alpha, stream, seed=7)]
        qs, gts = pool[sel], gt[sel]
        for P_loc in P_LOCS:
            ids, _ = idx.search(
                qs, 10, probes=p, shared=P, tile=T, shared_local=P_loc,
                kk=64, batch_size=256, fallback=0,
            )
            rec = {
                "n": n, "alpha": alpha, "P_loc": P_loc, "p": p, "P": P,
                "T": T,
                "lanes_used": idx.last_lanes,
                "lane_window": (stream // T) * 8 * P_loc,
                "overflow": idx.last_overflow,
                "coverage": round(idx.last_coverage, 4),
                "recall10": round(recall_at_k(ids, gts, 10), 4),
            }
            emit(rec)
            rows.append(rec)

    with open(CSV, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=[
            "alpha", "P_loc", "lanes_used", "lane_window", "overflow",
            "coverage", "recall10",
        ])
        w.writeheader()
        for r in rows:
            w.writerow({k: r[k] for k in w.fieldnames})
    print(f"# wrote {CSV}", flush=True)

    # --- sharded fastflat leg: skew-INVARIANT by construction -------
    # Every shard scans its whole row range for every query (queries
    # all_gather'd, results psum'd), so the cost counters are a pure
    # function of (nq, kb) — there is no hot-data concentration to
    # exploit or to suffer. The grid demonstrates it: counters are
    # identical across alpha, and recall holds at every alpha (the
    # reference's cache-based CN, by contrast, needs the skew to win —
    # exp_cache_size_and_skew.py).
    from shine_tpu.io.device_synth import device_rowkeyed_ext_dataset
    from shine_tpu.parallel.fastflat_sharded import ShardedFastFlatIndex

    ds = device_rowkeyed_ext_dataset(
        n=n, dim=d, num_queries=npool, seed=25, gt_k=10, mesh=mesh,
    )
    ff = ShardedFastFlatIndex.from_ext(
        ds.ext_dev, n, mesh, dim=d, row_source=ds.row_source,
    )
    fpool = np.asarray(ds.queries)  # this leg's query pool (own GT)
    for alpha in ALPHAS:
        perm = np.random.default_rng(31).permutation(npool)
        sel = perm[zipf_ranks(npool, alpha, stream, seed=7)]
        qs, gts = fpool[sel], ds.ground_truth[sel]
        for kb in (16, 32, 64):
            ids, _ = ff.search(qs, 10, kb=kb, batch_size=256)
            cc = ff.cost_counters(len(qs), 10, kb=kb)
            emit({
                "family": "fastflat_sharded", "n": n, "alpha": alpha,
                "kb": kb,
                "ici_exchange_bytes": cc["ici_exchange_bytes"],
                "scanned_rows": cc["scanned_rows"],
                "recall10": round(recall_at_k(ids, gts, 10), 4),
            })


if __name__ == "__main__":
    main()
