#!/usr/bin/env python
"""Host reverse-merge stage benchmark: numpy twin vs the native C++ port.

A 10M fastbuild profile put _reverse_merge at 545 s of a 1924 s M=16
build and 1404 s of a 6173 s M=32 build on one host core — numpy's
three global lexsorts
over the (n*M,) edge list. The C++ stage (native/hnsw_builder.cc:
shine_reverse_merge, bit-identical, tests/test_build.py) replaces them
with one counting sort + per-row small sorts.

Synthetic layer-0-shaped input: ids=arange(n), per-row ascending
distances, cap_c = M_max0 + M (the build_level call shape).

Env: SHINE_RM_N (10_485_760), SHINE_RM_M (32), SHINE_RM_NUMPY (1 = also
time the numpy twin; it is ~10-25 min at 10M). Appends
results/bench_reverse_merge.jsonl.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# host-only benchmark, but importing the numpy twin pulls in jax-using
# modules — force CPU so it never reserves an accelerator
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

N = int(os.environ.get("SHINE_RM_N", 10_485_760))
M = int(os.environ.get("SHINE_RM_M", 32))
CAP_C = 2 * M + M  # build_level(ids, M, M0=2M): cap_c = cap + m_out
OUT = os.path.join(ROOT, "results", "bench_reverse_merge.jsonl")


def emit(rec: dict) -> None:
    rec = {"n": N, "M": M, "cap_c": CAP_C, **rec}
    print("#", json.dumps(rec), flush=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(rec) + "\n")


def main() -> None:
    rng = np.random.default_rng(11)
    print(f"# generating ({N}, {M}) synthetic forward edges", flush=True)
    fwd_sel = rng.integers(0, N, (N, M), dtype=np.int32)
    fwd_d = np.sort(rng.random((N, M), dtype=np.float32), axis=1)
    ids = np.arange(N, dtype=np.int32)

    from shine_tpu.native import reverse_merge

    t0 = time.time()
    cand_n, cd_n = reverse_merge(fwd_sel, fwd_d, ids, CAP_C)
    emit({"engine": "native", "seconds": round(time.time() - t0, 1)})

    if os.environ.get("SHINE_RM_NUMPY", "0") == "1":
        from shine_tpu.models.fastbuild import _reverse_merge_np

        t0 = time.time()
        cand_p, cd_p = _reverse_merge_np(fwd_sel, fwd_d, ids, CAP_C)
        emit({"engine": "numpy", "seconds": round(time.time() - t0, 1)})
        np.testing.assert_array_equal(cand_n, cand_p)
        np.testing.assert_array_equal(cd_n, cd_p)
        print("# identity holds at scale", flush=True)


if __name__ == "__main__":
    main()
