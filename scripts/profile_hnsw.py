#!/usr/bin/env python
"""HNSW dispatch decomposition at 1M: the graph family's stage breakdown.

Stages measured (results/profile_hnsw.jsonl):
  gather-floor  — raw row-gather microbench at the beam step's shape
                  (B, E*2M rows): the bandwidth speed-of-light the
                  traversal can at best hit.
  dist-floor    — one fused gather+distance program (_dist_ext), i.e.
                  a single beam step's compute outside the while_loop.
  step-ladder   — full search wall vs max_steps cap: the while_loop
                  runs to the LAGGARD query's convergence; wall(steps)
                  regression gives fixed overhead + marginal ms/step,
                  recall(steps) shows where capping starts costing.
  config-grid   — ef x frontier x term x rows(f32|bf16): operating
                  points (qps, recall) for the ladder.

Uses a 1M M=32 graph checkpoint (SHINE_PROF_CKPT); rebuilds only if
absent. Reference analogue: the
coroutine scheduler's latency-hiding decomposition (scheduler.hh:81-86).

Env: SHINE_PROF_N (1048576), SHINE_PROF_M (32), SHINE_PROF_EFC (500),
SHINE_PROF_B (2048). Run it where JAX finds the GPU; JAX_PLATFORMS=cpu
with a small SHINE_PROF_N rehearses it on the host.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from shine_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

N = int(os.environ.get("SHINE_PROF_N", 1_048_576))
D = int(os.environ.get("SHINE_PROF_D", 128))
M = int(os.environ.get("SHINE_PROF_M", 32))
EFC = int(os.environ.get("SHINE_PROF_EFC", 500))
B = int(os.environ.get("SHINE_PROF_B", 2048))
NQ = 2048
OUT = os.path.join(ROOT, "results", "profile_hnsw.jsonl")


def emit(rec: dict) -> None:
    rec = {"n": N, "d": D, "M": M, "pool": EFC, "B": B, **rec}
    print("#", json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(rec) + "\n")


def main() -> None:
    import jax
    import jax.numpy as jnp

    from shine_tpu.config import HNSWParams, SearchParams
    from shine_tpu.io import load_graph, recall_at_k
    from shine_tpu.io.device_synth import device_synthetic_dataset
    from shine_tpu.models import HNSWIndex
    from shine_tpu.models.hnsw import _dist_ext, _extend_query

    ds = device_synthetic_dataset(n=N, dim=D, num_queries=NQ, seed=29,
                                  gt_k=10)
    gt = np.asarray(ds.ground_truth)
    queries = np.asarray(ds.queries, np.float32)

    tag = ("" if M == 16 else f"_m{M}") + (f"_efc{EFC}" if EFC else "")
    ckpt = os.environ.get("SHINE_PROF_CKPT") or os.path.join(
        ROOT, ".bench_cache", f"hnsw10m_{N}x{D}{tag}.npz"
    )
    if os.path.exists(ckpt):
        graph = load_graph(ckpt)
        emit({"stage": "graph", "loaded": ckpt})
    else:
        from shine_tpu.io import save_graph
        from shine_tpu.models.fastbuild import fast_build_graph

        t0 = time.time()
        base = np.asarray(ds.base_dev)
        graph = fast_build_graph(
            base, HNSWParams(M=M, ef_construction=EFC or 200),
            base_dev=ds.base_dev, pool=EFC,
        )
        save_graph(graph, ckpt)
        emit({"stage": "graph", "built_seconds": round(time.time() - t0, 1)})
    del ds.base_dev

    def timed(fn, reps=3):
        fn()  # compile + warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            best = min(best, time.perf_counter() - t0)
        return best

    for rows in ("f32", "bf16"):
        idx = HNSWIndex(graph, rows=rows)
        g = idx.device

        # --- gather floor: one (B, E*2M) row gather + reduce ---
        E = 8
        K = E * 2 * M
        rng = np.random.default_rng(0)
        ids = jnp.asarray(rng.integers(0, N, (B, K), dtype=np.int32))

        # device tables MUST be jit ARGUMENTS: a closure capture inlines
        # the (N, d) table into the HLO as a constant and the compile
        # request blows the service's body limit (HTTP 413 at 1M x 128,
        # chip_plan_r5final stage E; the r2 captured-constant hazard)
        @jax.jit
        def gather_only(vecs, ids):
            rows_ = vecs[ids]  # (B, K, dp)
            return rows_.astype(jnp.float32).sum(axis=(1, 2))

        s = timed(lambda: gather_only(g.vectors_ext, ids))
        bytes_ = B * K * g.vectors_ext.shape[1] * g.vectors_ext.dtype.itemsize
        emit({"stage": "gather-floor", "rows": rows, "K": K,
              "ms": round(s * 1e3, 2), "gbs": round(bytes_ / s / 1e9, 1)})

        # --- dist floor: one fused gather+distance program ---
        q_ext, bias = _extend_query(
            jnp.asarray(queries[:B]), idx.metric, g.vectors_ext.shape[1]
        )
        dist_fn = jax.jit(
            lambda gg, q, b, ii: _dist_ext(gg, q, b, ii)
        )
        s = timed(lambda: dist_fn(g, q_ext, bias, ids))
        emit({"stage": "dist-floor", "rows": rows, "K": K,
              "ms": round(s * 1e3, 2), "gbs": round(bytes_ / s / 1e9, 1)})

        # --- step ladder at the headline config ---
        for cap in (4, 8, 12, 16, 24, 32, 48, 0):
            sp = SearchParams(k=10, ef=96, frontier=E, max_steps=cap or 0)
            t0 = time.perf_counter()
            ids_out, _ = idx.search(queries, sp, batch_size=B)
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            ids_out, _ = idx.search(queries, sp, batch_size=B)
            wall = min(wall, time.perf_counter() - t0)
            emit({"stage": "step-ladder", "rows": rows, "cap": cap,
                  "ef": 96, "frontier": E,
                  "qps": round(NQ / wall, 1),
                  "hops_per_q": round(idx.last_hops / NQ, 1),
                  "recall10": round(recall_at_k(ids_out, gt, 10), 4)})

        # --- config grid (term="k" = query-adaptive early exit) ---
        for ef in (64, 96, 128):
            for E2 in (4, 8, 16):
                for term in ("ef", "k"):
                    sp = SearchParams(k=10, ef=ef, frontier=E2, term=term)
                    idx.search(queries[:B], sp, batch_size=B)  # compile
                    t0 = time.perf_counter()
                    ids_out, _ = idx.search(queries, sp, batch_size=B)
                    wall = time.perf_counter() - t0
                    emit({"stage": "config", "rows": rows, "ef": ef,
                          "frontier": E2, "term": term,
                          "qps": round(NQ / wall, 1),
                          "hops_per_q": round(idx.last_hops / NQ, 1),
                          "recall10": round(recall_at_k(ids_out, gt, 10),
                                            4)})
        del idx, g


if __name__ == "__main__":
    main()
