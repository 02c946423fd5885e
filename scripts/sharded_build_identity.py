"""Mid-scale sharded-construction identity run (VERDICT-r3 item #2b).

The bit-identity between single-chip and mesh-sharded fastbuild is
guaranteed by tests at small shapes (tests/test_build.py); this script
runs the same assertion at a NON-toy scale on the 8-device CPU mesh and
records the artifact, so the 100M-class sharded-build claim rests on a
measured mid-scale run, not only unit shapes. Reference analogue: the
distributed insert path (/root/reference/src/hnsw/hnsw.hh insert RPCs)
has no single-node twin to compare against — ours does, by construction
(plan/apply rounds are deterministic; SURVEY.md §7.1).

Env: SHINE_SBI_N (default 65536), SHINE_SBI_D (64), SHINE_SBI_M (16).
Writes results/sharded_build_identity.jsonl. CPU-only (forces the
8-device host platform like tests/conftest.py).
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# append (not setdefault): a pre-set XLA_FLAGS would otherwise drop the
# 8-virtual-device flag and shard_mesh(8) fails on a 1-device CPU
_FLAG = "--xla_force_host_platform_device_count=8"
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " " + _FLAG
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

N = int(os.environ.get("SHINE_SBI_N", 65536))
D = int(os.environ.get("SHINE_SBI_D", 64))
M = int(os.environ.get("SHINE_SBI_M", 16))
OUT = os.path.join(os.path.dirname(__file__), "..", "results",
                   "sharded_build_identity.jsonl")


def emit(row):
    row = {"n": N, "d": D, "M": M, **row}
    print("#", json.dumps(row), flush=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(row) + "\n")


def main():
    import shine_tpu.models.fastbuild as fb
    from shine_tpu.config import HNSWParams, SearchParams
    from shine_tpu.io import recall_at_k
    from shine_tpu.io.datasets import synthetic_dataset
    from shine_tpu.models.hnsw import HNSWIndex
    from shine_tpu.parallel import shard_mesh
    from shine_tpu.parallel.sharded import ShardedIndex

    ds = synthetic_dataset(n=N, dim=D, num_queries=256, seed=11)
    p = HNSWParams(M=M, ef_construction=max(2 * M, 32))

    # exact_knn=True: the kNN stages take the exact f32 scans
    # (FlatIndex single-device / ShardedFlatIndex on the mesh — the
    # documented bit-identical pairing)
    t0 = time.time()
    g1 = fb.fast_build_graph(ds.base, p, exact_knn=True)
    emit({"stage": "build-single", "seconds": round(time.time() - t0, 1)})

    mesh = shard_mesh(8)
    t0 = time.time()
    g2 = fb.fast_build_graph(ds.base, p, mesh=mesh, exact_knn=True)
    emit({"stage": "build-mesh8", "seconds": round(time.time() - t0, 1)})

    ident = {}
    for name in ("levels", "neighbors0", "upper_row", "upper_neighbors"):
        a, b = getattr(g1, name), getattr(g2, name)
        ident[name] = bool(np.array_equal(np.asarray(a), np.asarray(b)))
    ident["entry_point"] = g1.entry_point == g2.entry_point
    ident["top_level"] = g1.top_level == g2.top_level
    emit({"stage": "identity", **ident})
    assert all(ident.values()), f"sharded build diverged: {ident}"

    sp = SearchParams(k=10, ef=64)
    ids1, _ = HNSWIndex(g1).search(ds.queries, sp)
    ids2, _ = ShardedIndex(g2, mesh).search(ds.queries, sp, batch_size=256)
    r1 = recall_at_k(ids1, ds.ground_truth, 10)
    r2 = recall_at_k(ids2, ds.ground_truth, 10)
    emit({"stage": "serve", "recall10_single": round(float(r1), 4),
          "recall10_mesh8": round(float(r2), 4),
          "ids_equal": bool(np.array_equal(ids1, ids2))})


if __name__ == "__main__":
    main()
