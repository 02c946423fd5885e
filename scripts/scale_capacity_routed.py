#!/usr/bin/env python
"""Routed split-layout capacity serving on the real chip.

The flat split scan serves 100M rows at ~2k QPS (VPU-select-bound full
sweep). This measures models/routed_split.py — balanced-clustered int8
split tables + tile-shared probing + exact regen re-rank — at the same
row counts: the scan touches ~shared*cap rows per tile instead of N,
targeting ~10x the QPS at recall >= the reference's 0.95 operating
point (/root/reference/scripts/datasets.py:12-20).

Queries/rows use the same row-keyed PRNG recipe (seed 17) as
scale_capacity_split.py so recall numbers are directly comparable.

Env: SHINE_CR_N (default 41_943_040), SHINE_CR_C (2048), SHINE_CR_SLACK
(1.05), SHINE_CR_SWEEP ("p:P:T,..." default "16:24:64,32:48:64,
32:64:128,64:96:128"). Appends results/scale_capacity_routed.jsonl.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# SHINE_CR_CPU=1: run the WHOLE script on the host CPU (tiny N) — a
# rehearsal before a run on the card
_CPU_SMOKE = os.environ.get("SHINE_CR_CPU") == "1"
if _CPU_SMOKE:
    import jax

    jax.config.update("jax_platforms", "cpu")

from shine_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

N = int(os.environ.get("SHINE_CR_N", 41_943_040))
D = 128
CAP = int(os.environ.get("SHINE_CR_CAP", 4096))
CLS = int(os.environ.get("SHINE_CR_CLS", 1024))
SLACK = float(os.environ.get("SHINE_CR_SLACK", 1.05))
# knobs picked by the CPU routing study (results/route_coverage.jsonl,
# scripts/route_coverage_study.py): T=32 is the coverage knob at 10k+
# clusters (T>=64 tiles want more distinct clusters than any grant);
# at 41.9M geometry p16/P192/T32 routes at coverage 0.997,
# p16/P128/T32 at 0.965, p32/P192/T32 at 0.980
# sweep cells p:P:T[:kk] — kk (exact-re-rank survivor width, default
# 8*k) is the 4th axis of the 100M >=0.99 hunt: at p=128 coverage is
# already 1.0, so if recall moves with kk the plateau is int8 scan-score
# ordering, not probe reach (VERDICT r4 #5)
SWEEP = [
    (lambda v: (v + [0])[:4])([int(x) for x in s.split(":")])
    for s in os.environ.get(
        "SHINE_CR_SWEEP", "16:96:32,16:128:32,16:192:32,32:192:32,32:256:32"
    ).split(",")
]
NQ = 2048
SEED = 17
OUT = os.path.join(
    ROOT, "results",
    "scale_capacity_routed.smoke.jsonl" if _CPU_SMOKE
    else "scale_capacity_routed.jsonl",
)


def emit(rec: dict) -> None:
    rec = {"n": N, "d": D, "nq": NQ, "cap": CAP, "cls": CLS, "slack": SLACK, **rec}
    print("#", json.dumps(rec), flush=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(rec) + "\n")


def main() -> None:
    import jax
    import jax.numpy as jnp

    from shine_tpu.io import recall_at_k
    from shine_tpu.io.device_synth import regen_rows
    from shine_tpu.models.routed_split import build_routed_split

    # same dataset recipe as device_rowkeyed_split_dataset(seed=17)
    k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(SEED), 4)
    centers = jax.random.normal(k0, (64, D), jnp.float32) * 4.0
    qidx = jax.random.randint(k2, (NQ,), 0, N)
    anchors = regen_rows(k1, centers, qidx)
    queries = np.asarray(
        anchors + 0.3 * jax.random.normal(k3, (NQ, D), jnp.float32)
    )

    from shine_tpu.io.checkpoint import load_routed_split, save_routed_split

    # v3: balance-refined centroids (96 rows/cluster training floor) +
    # R=8 choices + ITERATIVE nearest-open widen (the r3 spill fixes) —
    # an older checkpoint must not satisfy a v3 run
    ckpt = os.path.join(
        ROOT, ".bench_cache",
        f"routed_{N}x{D}_c{CAP}_{CLS}_sl{SLACK}_s{SEED}_v3.npz",
    )
    gt_path = ckpt.replace(".npz", "_gt.npy")
    t0 = time.time()
    save_after = False
    if os.path.exists(ckpt) and os.path.exists(gt_path):
        idx = load_routed_split(ckpt)
        gt = np.load(gt_path)
        print(f"# loaded checkpoint {ckpt}", flush=True)
    else:
        # gt_k=11: the extra column feeds margin_mask (artifact-free
        # id-recall on real-boundary queries); older 10-col GT caches
        # still load, margin is just skipped for them
        idx, gt = build_routed_split(
            N, D, row_source=(k1, centers), cap_target=CAP, cls=CLS,
            cap_slack=SLACK, comp_dtype="int8", seed=SEED, queries=queries,
            gt_k=11, log=lambda m: print(m, flush=True),
        )
        os.makedirs(os.path.dirname(gt_path), exist_ok=True)
        np.save(gt_path, gt)
        # checkpoint AFTER the sweep: the 100M comp download is ~14 GB —
        # measure first so a timeout still records the sweep.
        # SHINE_CR_SAVE=0 skips it entirely.
        save_after = os.environ.get("SHINE_CR_SAVE", "1") == "1"
    if os.environ.get("SHINE_GT_CROSSCHECK", "1") == "1":
        # scorer self-certification (VERDICT r4 #6): device exact scorer
        # vs numpy oracle on a regenerated row subset
        from shine_tpu.io.device_synth import rowkeyed_scorer_crosscheck

        t1 = time.time()
        ov = rowkeyed_scorer_crosscheck(
            (k1, centers), queries,
            n_sub=int(os.environ.get("SHINE_GT_NSUB", 524_288)),
        )
        emit({"stage": "gt-crosscheck", "gt_overlap": round(float(ov), 4),
              "seconds": round(time.time() - t1, 1)})
        assert ov > 0.995, f"device scorer corrupt (overlap {ov})"
    table_gb = (idx.comp.nbytes + idx.aux_r.nbytes + idx.gid.nbytes) / 1e9
    emit({
        "stage": "ingest", "seconds": round(time.time() - t0, 1),
        "C": idx.C, "cap_actual": idx.cap,
        "fill": round(N / (idx.C * idx.cap), 4),
        "table_gb": round(table_gb, 2),
    })

    def eps(ids):
        # distance-tolerance recall: this synthetic family's id-recall
        # ceiling collapses under near-ties at 10M+ rows (r2 10M eps
        # analysis: id 0.9155 = eps 0.9987); rows regenerate exactly
        # from their ids, so the scorer needs no resident base
        if idx.row_source is None:
            return None
        from shine_tpu.io.recall import recall_at_k_eps_regen

        return round(
            recall_at_k_eps_regen(ids, queries, idx.row_source, gt, 10), 4
        )

    mm = None
    if gt.shape[1] >= 11 and idx.row_source is not None:
        from shine_tpu.io import margin_mask

        mm = margin_mask(queries, None, gt, 10,
                         row_source=idx.row_source)
        emit({"stage": "margin",
              "margin_frac": round(float(mm.mean()), 4)})

    def margin(ids):
        if mm is None:
            return None
        return round(recall_at_k(ids[mm], gt[mm], 10), 4)

    pre = idx.preload(queries, batch_size=2048)
    for p, P, T, kk in SWEEP:
        # fallback=0: measure the raw routed pass; the spill guarantee
        # is timed separately below at the best knob set
        kw = dict(probes=p, shared=P, tile=T, kk=kk, batch_size=2048,
                  preloaded=pre, with_dists=False, fallback=0)
        ids, _ = idx.search(queries, 10, **kw)  # compile + warm
        best = float("inf")
        for _ in range(2):
            t1 = time.time()
            ids, _ = idx.search(queries, 10, **kw)
            best = min(best, time.time() - t1)
        emit({
            "stage": "search", "p": p, "P": P, "T": T, "kk": kk,
            "qps": round(NQ / best, 1),
            "recall10": round(recall_at_k(ids, gt, 10), 4),
            "recall10_eps": eps(ids),
            "recall10_margin": margin(ids),
            "coverage": round(idx.last_coverage, 4),
        })

    # the guaranteed-floor configuration (default fallback=0.5) at the
    # first sweep point: spill count + its QPS cost
    p, P, T, kk = SWEEP[0]
    kw = dict(probes=p, shared=P, tile=T, kk=kk, batch_size=2048,
              preloaded=pre, with_dists=False)
    ids, _ = idx.search(queries, 10, **kw)
    best = float("inf")
    for _ in range(2):
        t1 = time.time()
        ids, _ = idx.search(queries, 10, **kw)
        best = min(best, time.time() - t1)
    emit({
        "stage": "search_fallback", "p": p, "P": P, "T": T,
        "qps": round(NQ / best, 1),
        "recall10": round(recall_at_k(ids, gt, 10), 4),
        "recall10_eps": eps(ids),
        "coverage": round(idx.last_coverage, 4),
        "fallback_queries": idx.last_fallback,
    })

    if save_after:
        t1 = time.time()
        save_routed_split(idx, ckpt)
        emit({"stage": "checkpoint", "seconds": round(time.time() - t1, 1)})

    if os.environ.get("SHINE_CR_RECENTER") == "1":
        # A/B leg: routing centroids -> assigned-member means (the
        # displacement hypothesis behind the 100M p=128 recall plateau
        # at coverage 1.0; see RoutedSplitIndex.recenter_routing), then
        # re-run the same sweep for a direct comparison in one artifact
        t1 = time.time()
        idx.recenter_routing()
        emit({"stage": "recenter", "seconds": round(time.time() - t1, 1)})
        for p, P, T, kk in SWEEP:
            kw = dict(probes=p, shared=P, tile=T, kk=kk, batch_size=2048,
                      preloaded=pre, with_dists=False, fallback=0)
            ids, _ = idx.search(queries, 10, **kw)
            best = float("inf")
            for _ in range(2):
                t1 = time.time()
                ids, _ = idx.search(queries, 10, **kw)
                best = min(best, time.time() - t1)
            emit({
                "stage": "search_recentered", "p": p, "P": P, "T": T,
                "kk": kk,
                "qps": round(NQ / best, 1),
                "recall10": round(recall_at_k(ids, gt, 10), 4),
                "recall10_eps": eps(ids),
                "recall10_margin": margin(ids),
                "coverage": round(idx.last_coverage, 4),
            })


if __name__ == "__main__":
    main()
