"""The Pallas class-max kernel (ops/classmax_triton.py) in interpret mode,
and the FastFlatIndex family on the CPU engine."""

import jax.numpy as jnp
import numpy as np


def test_fast_flat_index_interpret():
    from shine_tpu.io import recall_at_k, synthetic_dataset
    from shine_tpu.models.flat import FastFlatIndex

    ds = synthetic_dataset(n=5000, dim=32, num_queries=128, seed=3)
    idx = FastFlatIndex(ds.base)
    ids, dd = idx.search(ds.queries, 10, kb=64)
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.98
    assert np.all(np.diff(dd, axis=1) >= -1e-3)


def test_fast_flat_ip_metric():
    from shine_tpu.io import recall_at_k, synthetic_dataset
    from shine_tpu.models.flat import FastFlatIndex

    ds = synthetic_dataset(n=4096, dim=32, num_queries=64, seed=5, metric="ip")
    idx = FastFlatIndex(ds.base, metric="ip")
    ids, _ = idx.search(ds.queries, 10, kb=64)
    assert recall_at_k(ids, ds.ground_truth, 10) > 0.97


def test_classmax2_scan_interpret(rng):
    """The kernel's class-max + runner-up (interpret mode) vs a numpy
    top-2-per-class oracle."""
    from shine_tpu.ops.classmax_triton import classmax_triton

    n, cls, B = 2048, 128, 64
    ext = jnp.asarray(
        rng.normal(size=(n, 160)).astype(np.float32), dtype=jnp.bfloat16
    )
    q = jnp.asarray(
        rng.normal(size=(B, 160)).astype(np.float32), dtype=jnp.bfloat16
    )
    m1, a1, m2, a2 = classmax_triton(
        ext, q, cls=cls, keep2=True, tq=32, tc=32, interpret=True
    )
    sc = np.asarray(q, np.float32) @ np.asarray(ext, np.float32).T  # (B, N)
    cls_of = np.arange(n) % cls  # class = row % cls
    want1 = np.full((B, cls), -np.inf, np.float32)
    want2 = np.full((B, cls), -np.inf, np.float32)
    for c in range(cls):
        s = np.sort(sc[:, cls_of == c], axis=1)
        want1[:, c] = s[:, -1]
        want2[:, c] = s[:, -2]
    np.testing.assert_allclose(np.asarray(m1), want1, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(m2), want2, rtol=1e-5, atol=1e-4)
    # ids must point at rows of the right class and score
    for rows, m in ((a1, m1), (a2, m2)):
        rows = np.asarray(rows)
        assert (rows % cls == np.arange(cls)[None, :]).all()
        got = np.take_along_axis(sc, rows, axis=1)
        np.testing.assert_allclose(got, np.asarray(m), rtol=1e-5, atol=1e-5)
    assert (np.asarray(a1) != np.asarray(a2)).all()


def test_fastflat_keep2_recall_adversarial(rng):
    """Small cls (many rows per class) loses near-tie neighbors; keep2
    must recover them: recall with the runner-up is high and not below
    the keep1 scan's."""
    from shine_tpu.io import recall_at_k
    from shine_tpu.models.flat import FastFlatIndex, FlatIndex

    n, d = 8192, 32
    base = rng.normal(size=(n, d)).astype(np.float32)
    queries = base[rng.integers(0, n, 64)] + 0.01 * rng.normal(
        size=(64, d)
    ).astype(np.float32)
    exact = FlatIndex(base)
    gt, _ = exact.search(queries, 10, use_bf16=False)
    fast = FastFlatIndex(base)
    ids2, _ = fast.search(queries, 10, kb=32, cls=256, keep2=True)
    ids1, _ = fast.search(queries, 10, kb=32, cls=256, keep2=False)
    r2 = recall_at_k(ids2, np.asarray(gt), 10)
    assert r2 > 0.9
    assert r2 >= recall_at_k(ids1, np.asarray(gt), 10)
