#!/usr/bin/env python
"""10M-row HNSW graph on chip (r3 stretch): device-resident fastbuild.

The reference's core index is HNSW at 100M rows across 5 memory nodes
(src/hnsw/hnsw.hh, memory_node.hh:112-125) — ~20M rows per node. This
builds a 10M x 128 graph on ONE chip + one host core: layer-0 self-kNN
as a fused device sweep (fastbuild._knn_device_sweep — only the (n, k)
results leave the device), selects against the resident base, host-side
deterministic reverse merge, then serves it with batched_search.

Env: SHINE_10MH_N (default 10_485_760), SHINE_10MH_D (128).
Appends results/scale_10m_hnsw.jsonl.
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

N = int(os.environ.get("SHINE_10MH_N", 10_485_760))
M = int(os.environ.get("SHINE_10MH_M", 16))
D = int(os.environ.get("SHINE_10MH_D", 128))
# efc-parity pool: exact top-`pool` candidate lists feed select_heuristic
# (the reference's ef_construction analog — fastbuild docstring); 0 keeps
# the scan-speed default (2M)
POOL = int(os.environ.get("SHINE_10MH_EFC", 0))
# serving row storage: 20M-row graphs need bf16 rows for base+adjacency
# to coexist in 16 GB HBM (models/hnsw.py quantized upload)
ROWS = os.environ.get("SHINE_10MH_ROWS", "f32")
NQ = 2048
OUT = os.path.join(ROOT, "results", "scale_10m_hnsw.jsonl")


def emit(rec: dict) -> None:
    rec = {"n": N, "d": D, "nq": NQ, "M": M, "pool": POOL, "rows": ROWS,
           **rec}
    print("#", json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(rec) + "\n")


def main() -> None:
    from shine_tpu.config import HNSWParams, SearchParams
    from shine_tpu.io import margin_mask, recall_at_k
    from shine_tpu.io.device_synth import device_synthetic_dataset
    from shine_tpu.models import HNSWIndex
    from shine_tpu.models.fastbuild import fast_build_graph

    t0 = time.time()
    # gt_k=11: the 11th column feeds margin_mask below
    ds = device_synthetic_dataset(
        n=N, dim=D, num_queries=NQ, seed=29, gt_k=11
    )
    emit({"stage": "gen+gt", "seconds": round(time.time() - t0, 1)})
    # computed while the base is still resident; applied to the search
    # ids after the base is freed (only GT + queries are needed)
    mm = margin_mask(ds.queries, ds.base_dev, ds.ground_truth, 10,
                     rtol=1e-4)
    emit({"stage": "margin", "margin_frac": round(float(mm.mean()), 4)})

    os.environ["SHINE_FASTBUILD_TIMING"] = "1"
    params = HNSWParams(M=M, ef_construction=POOL or 200)
    tag = ("" if M == 16 else f"_m{M}") + (f"_efc{POOL}" if POOL else "")
    ckpt = os.path.join(ROOT, ".bench_cache", f"hnsw10m_{N}x{D}{tag}.npz")
    if os.path.exists(ckpt) and os.environ.get("SHINE_10MH_REBUILD") != "1":
        from shine_tpu.io import load_graph

        graph = load_graph(ckpt)
        emit({"stage": "fastbuild", "seconds": 0.0, "loaded": ckpt})
    else:
        t0 = time.time()
        # row-keyed generation is deterministic in (n, d, seed), so the
        # host copy is cacheable: pay the 8.6 GB download at 16.78M once
        # per geometry, then load from disk
        base_cache = os.path.join(ROOT, ".bench_cache",
                                  f"base_{N}x{D}_s29.npy")
        if os.path.exists(base_cache):
            base = np.load(base_cache)
            emit({"stage": "base-download",
                  "seconds": round(time.time() - t0, 1),
                  "gb": round(base.nbytes / 1e9, 2), "cached": True})
        else:
            base = np.asarray(ds.base_dev)  # host copy (graph + selects)
            emit({"stage": "base-download",
                  "seconds": round(time.time() - t0, 1),
                  "gb": round(base.nbytes / 1e9, 2)})
            os.makedirs(os.path.dirname(base_cache), exist_ok=True)
            np.save(base_cache, base)
        # scorer self-certification (VERDICT r4 #6): exact numpy GT on a
        # query subset vs the device GT — the independent witness the r4
        # precision incident proved the margin/eps instruments can't be
        t0 = time.time()
        from shine_tpu.io import gt_crosscheck

        ov = gt_crosscheck(
            np.asarray(ds.queries), base, np.asarray(ds.ground_truth),
            10, n_eval=int(os.environ.get("SHINE_GT_NEVAL", 256)),
        )
        emit({"stage": "gt-crosscheck", "gt_overlap": round(float(ov), 4),
              "seconds": round(time.time() - t0, 1)})
        assert ov > 0.995, f"device GT corrupt (overlap {ov})"
        # crash-resume checkpoint for layer 0 (~80% of the build wall).
        # A leftover stage file would make
        # the reported build seconds a lie, so unless the caller asks to
        # resume (SHINE_10MH_RESUME=1) a stale one is removed first.
        stage = ckpt.replace(".npz", "_stage0.npz")
        if (os.environ.get("SHINE_10MH_RESUME") != "1"
                and os.path.exists(stage)):
            os.remove(stage)
        t0 = time.time()
        graph = fast_build_graph(
            base, params, base_dev=ds.base_dev, stage_path=stage,
            pool=POOL,
        )
        build_s = time.time() - t0
        emit({"stage": "fastbuild", "seconds": round(build_s, 1)})
        from shine_tpu.io import save_graph

        save_graph(graph, ckpt)  # a ~70-min build deserves a checkpoint

    del ds.base_dev  # free 5-10 GB HBM before the search graph uploads
    idx = HNSWIndex(graph, rows=ROWS)
    efs = tuple(
        int(x) for x in os.environ.get("SHINE_10MH_EFS", "64,96,128").split(",")
    )
    for ef in efs:
        sp = SearchParams(k=10, ef=ef, frontier=8)
        ids, _ = idx.search(ds.queries, sp, batch_size=2048)
        best = float("inf")
        for _ in range(2):
            t1 = time.time()
            ids, _ = idx.search(ds.queries, sp, batch_size=2048)
            best = min(best, time.time() - t1)
        emit({"stage": "hnsw", "ef": ef, "qps": round(NQ / best, 1),
              "recall10": round(recall_at_k(ids, ds.ground_truth, 10), 4),
              "recall10_margin": round(
                  recall_at_k(ids[mm], ds.ground_truth[mm], 10), 4)})


if __name__ == "__main__":
    main()
