"""Regression tests for the f32 ranking-matmul precision bug class.

Root cause: DEFAULT matmul precision may run f32 operands at bfloat16 or
TF32 grade on an accelerator, so any exact/f32 ranking matmul that omits
`precision=` silently degrades to that grade on the device.
The device ground truth rode exactly such a path (flat_search's f32
scan), corrupting every >=1M id-recall reading until fixed with
`precision=HIGHEST`.

These tests lock the fix structurally: they trace the f32 ranking entry
points and assert every `dot_general` with float32 operands carries
HIGHEST precision. bf16-input matmuls are exempt (they run on the tensor
cores natively; DEFAULT is correct and fastest).

Reference analog: the reference's AVX2 distance kernels are always full
f32 (/root/reference/src/hnsw/dist.hh) — there is no silent-downcast
hazard to guard there; on an accelerator there is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shine_tpu.models.flat import FlatData, flat_search


def _f32_dots_without_highest(closed_jaxpr):
    """Walk a closed jaxpr (including sub-jaxprs from scan/while/cond/
    pjit) and return dot_general equations whose BOTH operands are f32
    but whose precision is not (HIGHEST, HIGHEST)."""
    bad = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                avals = [v.aval for v in eqn.invars]
                if all(a.dtype == jnp.float32 for a in avals):
                    prec = eqn.params.get("precision")
                    if prec != (jax.lax.Precision.HIGHEST,) * 2:
                        bad.append((eqn, prec))
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(closed_jaxpr.jaxpr)
    return bad


def _tiny_flat(n=2048, d=16, seed=0):
    rng = np.random.default_rng(seed)
    v = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    return FlatData(v, v.astype(jnp.bfloat16), jnp.sum(v * v, axis=-1),
                    jnp.int32(n))


def test_flat_search_f32_leg_uses_highest_precision():
    """The exact path every device ground truth rides (use_bf16=False)
    must carry HIGHEST on its f32 scan matmul — the r4 GT corruption."""
    data = _tiny_flat()
    q = jnp.zeros((8, 16), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda d_, q_: flat_search(d_, q_, k=10, use_bf16=False, chunk=1024)
    )(data, q)
    bad = _f32_dots_without_highest(jaxpr)
    assert not bad, (
        f"f32 ranking dot_general without HIGHEST precision: "
        f"{[(str(e.primitive), p) for e, p in bad]} — DEFAULT precision "
        "may run f32 operands at bf16/TF32 grade"
    )


def test_flat_search_bf16_rerank_uses_highest_precision():
    """The bf16 scan's exact f32 re-rank epilogue is a ranking matmul
    too; its einsum must stay HIGHEST."""
    data = _tiny_flat()
    q = jnp.zeros((8, 16), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda d_, q_: flat_search(d_, q_, k=10, use_bf16=True, chunk=1024)
    )(data, q)
    bad = _f32_dots_without_highest(jaxpr)
    assert not bad


def test_gt_fold_stream_uses_highest_precision():
    """fold_gt_stream computes capacity-mode ground truth; its distance
    matmuls are f32 and must be HIGHEST (they already were — this pins
    it)."""
    from shine_tpu.models.routed_split import fold_gt_stream

    rng = np.random.default_rng(1)
    rows = rng.standard_normal((4096, 16)).astype(np.float32)
    rows_dev = jnp.asarray(rows)

    q = rows[:8] + 1e-3
    gt = fold_gt_stream(lambda ids: rows_dev[ids], len(rows), q, 0,
                        gt_k=10, rchunk=1024)
    # value sanity: query perturbed from row i must rank i first
    assert (np.asarray(gt)[:, 0] == np.arange(8)).all()


def test_distance_module_default_precision_is_highest():
    """ops/distance.py DIST_PRECISION is the repo-wide knob every exact
    ranking matmul must ride; pin its value so a refactor can't quietly
    relax it."""
    from shine_tpu.ops.distance import DIST_PRECISION

    assert DIST_PRECISION == jax.lax.Precision.HIGHEST


def test_squared_norms_is_explicit_highest_dot():
    """squared_norms must lower to an explicit HIGHEST dot_general (not
    a bare reduce XLA could rewrite into a DEFAULT-precision self-dot)
    and match numpy f64 to f32 accuracy."""
    x = np.random.default_rng(0).standard_normal((64, 128)).astype(np.float32)
    from shine_tpu.ops.distance import squared_norms

    jaxpr = jax.make_jaxpr(squared_norms)(jnp.asarray(x))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots, "squared_norms must be an explicit contraction"
    assert not _f32_dots_without_highest(jaxpr)
    got = np.asarray(squared_norms(jnp.asarray(x)))
    want = (x.astype(np.float64) ** 2).sum(-1)
    np.testing.assert_allclose(got, want, rtol=2e-6)


@pytest.mark.parametrize("rows", ["f32", "bf16"])
def test_traversal_l2_is_explicit_highest_dot(rows):
    """The beam's L2 distances (hnsw._dist_ext -> distance.l2_rows, also
    the sharded traversal's form) square the differences in an explicit
    HIGHEST contraction, and match numpy f64 to f32 accuracy."""
    from shine_tpu.models.hnsw import DeviceGraph, _dist_ext
    from shine_tpu.ops.distance import l2_rows

    rng = np.random.default_rng(3)
    v = rng.standard_normal((256, 128)).astype(np.float32)
    q = rng.standard_normal((8, 128)).astype(np.float32)
    ids = rng.integers(-1, 256, size=(8, 32)).astype(np.int32)
    table = jnp.asarray(v, jnp.bfloat16 if rows == "bf16" else jnp.float32)
    g = DeviceGraph(vectors_ext=table, neighbors0=None, upper_row=None,
                    upper_neighbors=None, entry_point=None, upper_ids=None,
                    upper_vecs_ext=None, row_scl=None, row_nrm=None)
    q_ext = jnp.asarray(-2.0 * q)
    for fn, args in ((l2_rows, (jnp.asarray(q), table[np.maximum(ids, 0)])),
                     (lambda *a: _dist_ext(g, *a), (q_ext, q_ext[:, 0],
                                                    jnp.asarray(ids)))):
        jaxpr = jax.make_jaxpr(fn)(*args)
        assert any(e.primitive.name == "dot_general"
                   for e in jaxpr.jaxpr.eqns)
        assert not _f32_dots_without_highest(jaxpr)
    got = np.asarray(_dist_ext(g, q_ext, q_ext[:, 0], jnp.asarray(ids)))
    rows64 = np.asarray(table.astype(jnp.float32), np.float64)
    want = ((rows64[np.maximum(ids, 0)] - q[:, None, :]) ** 2).sum(-1)
    want = np.where(ids >= 0, want, np.inf)
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_device_pack_ext_norm_residual_is_exact():
    """pack_ext_device's c0+c1 norm pair must reconstruct -||v||^2 to
    ~2^-16 relative — the whole point of the residual encoding; a
    DEFAULT-precision norm would leave c1 as noise (a measured
    0.9914-vs-0.9999 recall gap at the scan stage)."""
    from shine_tpu.config import METRIC_L2
    from shine_tpu.ops.packing import ext_width, pack_ext_device

    rng = np.random.default_rng(2)
    v = rng.standard_normal((4096, 128)).astype(np.float32)
    ext = np.asarray(
        pack_ext_device(jnp.asarray(v), metric=METRIC_L2,
                        dp=ext_width(128), rchunk=1024)
    ).astype(np.float32)
    recon = ext[:, 128] + ext[:, 129]
    want = -(v.astype(np.float64) ** 2).sum(-1)
    err = np.abs(recon - want) / np.abs(want)
    assert err.max() < 2e-4, f"residual pair err {err.max():.2e}"


def test_device_synth_gt_matches_numpy_exactly():
    """device_synthetic_dataset's GT must agree with a pure-numpy f64
    brute force on every id (CPU run; the chip leg is r4f stage I)."""
    from shine_tpu.io.device_synth import device_synthetic_dataset

    ds = device_synthetic_dataset(n=4096, dim=32, num_queries=32, seed=3)
    base = np.asarray(ds.base_dev, np.float64)
    q = np.asarray(ds.queries, np.float64)
    d2 = ((q[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    k = ds.ground_truth.shape[1]
    order = np.argsort(d2 + np.arange(base.shape[0])[None, :] * 0.0, axis=1,
                       kind="stable")[:, :k]
    # tie-break (dist, id) ascending: stable argsort over dist already
    # yields id-ascending within exact ties
    gt = np.asarray(ds.ground_truth)
    agree = (gt == order).mean()
    assert agree == 1.0, f"GT/id mismatch rate {1 - agree:.4f}"
