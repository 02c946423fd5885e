"""chip_smoke.py's phases at tiny sizes on the CPU: the same functions the
GPU run calls, with the Triton kernel in the Pallas interpreter where a
phase compares engines."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def tiny():
    return chip_smoke.make_dataset(16384, 128, seed=4)


def test_smoke_gt_crosscheck(tiny):
    assert chip_smoke.crosscheck_gt(tiny, n_eval=64, chunk=4096) == 1.0


def test_smoke_phase_fastflat(tiny):
    res = chip_smoke.phase_fastflat(tiny, batch=64, reps=1, interpret=True)
    assert res["engine"] == "xla" and res["recall_eps"] >= 0.99
    assert res["search_s"] > 0 and res["build_s"] > 0
    assert [s["keep2"] for s in res["scan"]] == [False, True]
    assert all(s["rows_same"] >= 0.999 for s in res["scan"])


def test_smoke_scan_agreement(tiny):
    import jax.numpy as jnp

    from shine_tpu.models.flat import FastFlatIndex
    from shine_tpu.ops.packing import pack_ext_query

    idx = FastFlatIndex.from_device(tiny.base_dev[:4096], shuffle=False)
    q = pack_ext_query(jnp.asarray(tiny.queries[:40]), idx.ext.shape[1])
    out = chip_smoke.scan_agreement(
        idx.ext, q.astype(jnp.bfloat16), cls=256, keep2=True, interpret=True
    )
    assert out["rows_same"] >= 0.999 and out["max_abs_diff"] <= out["tol"]


def test_smoke_phase_hnsw(tiny):
    res, graph = chip_smoke.phase_hnsw(tiny, M=8, efc=32, efs=(32, 64),
                                       batch=64)
    assert res["ef"][64]["recall"] >= 0.95 and graph.n == tiny.n


def test_smoke_phase_split(tiny):
    assert chip_smoke.phase_split(tiny, batch=64)["recall"] >= 0.99


def test_smoke_phase_routed_ivf(tiny):
    res = chip_smoke.phase_routed_ivf(tiny, batch=64)
    assert res["routed"]["recall"] >= 0.9 and res["ivf"]["recall"] >= 0.9


def test_smoke_multi_phases(tiny):
    """The --multi comparisons on a 4-device CPU mesh."""
    from shine_tpu.parallel import shard_mesh

    mesh = shard_mesh(4)
    h = chip_smoke.multi_hnsw(tiny, mesh, M=8, efc=32, ef=32, batch=64)
    assert h["dense"]["ids_same"] >= 0.999 and h["compact"]["ids_same"] >= 0.999
    f = chip_smoke.multi_fastflat(tiny, mesh, kb=64, cls=1024, batch=64)
    assert f["ids_same"] >= 0.999


def test_smoke_refuses_cpu(capsys):
    """No accelerator: a non-zero exit and no result line."""
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "needs a GPU" in out.err
