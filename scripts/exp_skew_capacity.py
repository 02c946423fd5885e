#!/usr/bin/env python
"""Skew x probe-budget ablation for the capacity serving families (r4).

Reproduces the reference's headline experiment grid
(/root/reference/scripts/exp_cache_size_and_skew.py:8-31 — Zipf alpha x
cache-budget) on the routed-split capacity family: alpha resamples the
query stream from a fixed pool (io/skew.py, the reference's
create_queries.py protocol), and the probe budget p is the family's
serving-resource knob (the analogue of cache ratio: both trade memory
touches for recall on the hot mass).

Grid: alpha in {0, 0.75, 1.25} x p in {16, 32, 64} at 4.19M rows on the
chip (the measured v3 operating region, results/scale_capacity_routed.
jsonl). Emits results/skew_capacity.jsonl + a skew_r2.csv-style
results/skew_capacity.csv.

Env: SHINE_SKC_N (4_194_304), SHINE_SKC_STREAM (8192 resampled queries),
SHINE_SKC_CPU=1 (tiny CPU smoke).
"""

from __future__ import annotations

import csv
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from shine_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

_CPU = os.environ.get("SHINE_SKC_CPU") == "1"
if _CPU:
    import jax

    jax.config.update("jax_platforms", "cpu")

N = int(os.environ.get("SHINE_SKC_N", 65_536 if _CPU else 4_194_304))
D = 128
NPOOL = 1024 if _CPU else 2048
STREAM = int(os.environ.get("SHINE_SKC_STREAM", 2048 if _CPU else 8192))
ALPHAS = [0.0, 0.75, 1.25]
PROBES = [16, 32, 64]
# shared-tile budget axis (VERDICT r4 #9: the reference's cache-size
# sweep, exp_cache_size_and_skew.py:8-13, 2-25% of index): P = mult*p is
# the per-tile granted-union width — the serving-memory budget that,
# like the reference's cache ratio, trades resident working set for hot
# coverage. P/C is the resident-cluster fraction per tile batch.
SHARED_MULTS = [
    int(x) for x in os.environ.get("SHINE_SKC_SHARED", "12").split(",")
]
OUT = os.path.join(
    ROOT, "results",
    "skew_capacity.smoke.jsonl" if _CPU else "skew_capacity.jsonl",
)
CSV = OUT.replace(".jsonl", ".csv")


def emit(rec: dict) -> None:
    rec = {"n": N, "d": D, "pool": NPOOL, "stream": STREAM, **rec}
    print("#", json.dumps(rec), flush=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(rec) + "\n")


def main() -> None:
    import jax
    import jax.numpy as jnp

    from shine_tpu.io import recall_at_k
    from shine_tpu.io.device_synth import regen_rows
    from shine_tpu.io.skew import zipf_ranks
    from shine_tpu.models.routed_split import build_routed_split

    k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(17), 4)
    centers = jax.random.normal(k0, (64, D), jnp.float32) * 4.0
    qidx = jax.random.randint(k2, (NPOOL,), 0, N)
    anchors = regen_rows(k1, centers, qidx)
    pool = np.asarray(
        anchors + 0.3 * jax.random.normal(k3, (NPOOL, D), jnp.float32)
    )

    t0 = time.time()
    idx, gt = build_routed_split(
        N, D, row_source=(k1, centers), cap_target=1024 if _CPU else 4096,
        cls=256 if _CPU else 1024, cap_slack=1.05, comp_dtype="int8",
        seed=17, queries=pool, log=lambda m: print(m, flush=True),
    )
    emit({"stage": "ingest", "seconds": round(time.time() - t0, 1),
          "C": idx.C, "cap": idx.cap})

    rows = []
    for alpha in ALPHAS:
        # rank->pool permutation decorrelates popularity from id, like
        # the reference's shuffle (scripts/data/skew.py)
        rng = np.random.default_rng(31)
        perm = rng.permutation(NPOOL)
        ranks = zipf_ranks(NPOOL, alpha, STREAM, seed=7)
        sel = perm[ranks]
        qs = pool[sel]
        gts = gt[sel]
        pre = idx.preload(qs, batch_size=2048)
        for p in PROBES:
            for mult in SHARED_MULTS:
                kw = dict(probes=p, shared=mult * p, tile=32,
                          batch_size=2048, preloaded=pre,
                          with_dists=False, fallback=0)
                ids, _ = idx.search(qs, 10, **kw)  # compile + warm
                best = float("inf")
                for _ in range(2):
                    t1 = time.time()
                    ids, _ = idx.search(qs, 10, **kw)
                    best = min(best, time.time() - t1)
                rec = {
                    "stage": "cell", "alpha": alpha, "p": p,
                    "P": mult * p,
                    "budget_frac": round(mult * p / idx.C, 4),
                    "qps": round(STREAM / best, 1),
                    "recall10": round(recall_at_k(ids, gts, 10), 4),
                    "coverage": round(idx.last_coverage, 4),
                }
                emit(rec)
                rows.append(rec)

    with open(CSV, "w", newline="") as f:
        w = csv.DictWriter(
            f, fieldnames=["alpha", "p", "P", "budget_frac", "qps",
                           "recall10", "coverage"]
        )
        w.writeheader()
        for r in rows:
            w.writerow({k: r[k] for k in w.fieldnames})
    print(f"# wrote {CSV}", flush=True)


if __name__ == "__main__":
    main()
