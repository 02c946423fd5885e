"""bench.py smoke: the driver-facing benchmark entrypoint must run end to
end and print one valid JSON line (reference analogue: the harness's
benchmark runner, /root/reference/scripts/benchmark.py).

Runs as a subprocess with JAX_PLATFORMS=cpu (the explicit CPU smoke mode;
on the CPU the class-max scan takes its XLA engine) at tiny shapes — this
exercises the same code the GPU run times: dataset synth/cache, every
index family row, the sustained-stream replay row, and the headline
selection, so a row that crashes fails here instead of on the card.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_smoke(tmp_path):
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        SHINE_BENCH_N="8192",
        SHINE_BENCH_D="32",
        SHINE_BENCH_Q="256",
        SHINE_BENCH_BATCH="128",
        SHINE_BENCH_SKIP_HNSW="1",
        SHINE_BENCH_SUSTAIN="2",
        SHINE_BENCH_CACHE=str(tmp_path),
    )
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py")],
        env=env, capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["unit"] == "queries/s"
    assert doc["value"] > 0
    assert "recall10=" in doc["metric"]
    # every family row must have run (a crashed row logs "# ... failed")
    assert "failed" not in out.stderr, out.stderr[-2000:]
    assert "# fastflat sustained x2:" in out.stderr
    assert doc["device"]["platform"] == "cpu"


def test_bench_refuses_cpu_without_explicit_platform(tmp_path):
    """Off a GPU, bench.py runs only when JAX_PLATFORMS=cpu was set: an
    unset platform that resolves to the CPU exits non-zero, no JSON."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(SHINE_BENCH_CACHE=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py")],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr and not out.stdout.strip()


def test_bench_gate(tmp_path):
    """--gate: floors that hold -> rc 0; an unreachable floor or a
    missing row -> rc 2 with a GATE FAIL line."""
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        SHINE_BENCH_N="8192",
        SHINE_BENCH_D="32",
        SHINE_BENCH_Q="256",
        SHINE_BENCH_BATCH="128",
        SHINE_BENCH_SKIP_HNSW="1",
        SHINE_BENCH_SUSTAIN="0",
        SHINE_BENCH_CACHE=str(tmp_path),
    )
    ok_floors = tmp_path / "floors_ok.json"
    ok_floors.write_text(json.dumps({"flat": {"qps": 1, "recall10": 0.9}}))
    bad_floors = tmp_path / "floors_bad.json"
    bad_floors.write_text(json.dumps({
        "flat": {"qps": 10 ** 12, "recall10": 0.9},
        "no_such_row": {"qps": 1, "recall10": 0.0},
    }))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py"), "--gate"],
        env=dict(env, SHINE_BENCH_FLOORS=str(ok_floors)),
        capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "gate: all 1 floors held" in out.stderr
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py"), "--gate"],
        env=dict(env, SHINE_BENCH_FLOORS=str(bad_floors)),
        capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 2, (out.returncode, out.stderr[-2000:])
    assert "GATE FAIL" in out.stderr
    # the headline JSON still prints so the driver records the run
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["value"] > 0
