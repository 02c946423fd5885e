"""The class-max engines (ops/classmax.py, ops/classmax_triton.py), the
backend rule that picks one, and the compile-cache location."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shine_tpu.config import METRIC_IP, METRIC_L2


def _top2_per_class(s: np.ndarray, cls: int):
    """numpy reference: per class (row % cls) the top rows by
    (score desc, row asc), as (m1, r1, m2, r2)."""
    B, n = s.shape
    s3 = s.reshape(B, n // cls, cls)
    order = np.argsort(-s3, axis=1, kind="stable")
    lane = np.arange(cls)
    out = []
    for j in (0, 1):
        out.append(np.take_along_axis(s3, order[:, j:j + 1, :], 1)[:, 0])
        out.append(order[:, j, :] * cls + lane)
    return out


def _ext_case(rng, metric, n=3000, d=40, B=24):
    from shine_tpu.ops.packing import pack_ext_query, pack_ext_table

    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    n_pad = 4096
    ext = jnp.asarray(pack_ext_table(v, metric, n_pad), jnp.bfloat16)
    qe = pack_ext_query(jnp.asarray(q), ext.shape[1]).astype(jnp.bfloat16)
    # the bf16 operands are exact in f32, so the reference sums them in
    # f64: only the f32 accumulation order separates it from the engine
    s = (np.asarray(qe, np.float64) @ np.asarray(ext, np.float64).T)
    return ext, qe, s.astype(np.float32)


@pytest.mark.parametrize("keep2", [False, True], ids=["keep1", "keep2"])
@pytest.mark.parametrize("layout", ["ext_l2", "ext_ip", "split_int8"])
def test_xla_engine_matches_numpy(rng, layout, keep2):
    """The XLA class-max engine against a numpy top-2-per-class oracle:
    class maxima within f32 accumulation noise, and every returned row
    is of its class and carries its score."""
    from shine_tpu.ops.classmax import classmax_split, classmax_xla

    cls = 256
    if layout == "split_int8":
        from shine_tpu.ops.packing import pack_split_query, pack_split_tables

        v = rng.normal(size=(3000, 40)).astype(np.float32)
        qf = rng.normal(size=(24, 40)).astype(np.float32)
        comp, aux = pack_split_tables(v, METRIC_L2, 16384,
                                      comp_dtype=np.int8)
        q = pack_split_query(jnp.asarray(qf), comp.shape[1])
        out = classmax_split(jnp.asarray(comp), jnp.asarray(aux), q,
                             cls=cls, keep2=keep2, tn=1024)
        # the engine quantizes queries per row to int8 (symmetric)
        sq = np.maximum(np.abs(qf).max(1), 1e-30)
        qi = np.clip(np.rint(qf * (127.0 / sq[:, None])), -127, 127)
        dots = qi.astype(np.float64) @ comp[:, :40].astype(np.float64).T
        s = (dots * (sq / 127.0)[:, None] * aux[1][None, :]
             + aux[0][None, :]).astype(np.float32)
    else:
        metric = METRIC_L2 if layout == "ext_l2" else METRIC_IP
        ext, qe, s = _ext_case(rng, metric)
        out = classmax_xla(ext, qe, cls=cls, keep2=keep2, tn=512)
    want = _top2_per_class(s, cls)[: 4 if keep2 else 2]
    assert len(out) == len(want)
    scale = np.abs(s[s > -1e30]).max()
    for i in range(0, len(out), 2):
        m, r = np.asarray(out[i]), np.asarray(out[i + 1])
        np.testing.assert_allclose(m, want[i], rtol=0, atol=1e-5 * scale)
        assert (r % cls == np.arange(cls)[None, :]).all()
        np.testing.assert_allclose(
            np.take_along_axis(s, r, axis=1), m, rtol=0, atol=1e-5 * scale
        )
        assert (r == want[i + 1]).mean() > 0.99


@pytest.mark.parametrize("keep2", [False, True], ids=["keep1", "keep2"])
@pytest.mark.parametrize("shape", ["ragged_n", "odd_batch"])
def test_triton_interpret_matches_xla(rng, shape, keep2):
    """The Hopper kernel in the Pallas interpreter returns what the XLA
    engine returns: identical class maxima and rows (integer-valued bf16
    operands make every dot exact, ties included), for a table whose
    real row count is ragged (pad rows score NEG) and a batch that is not
    a multiple of the query tile."""
    from shine_tpu.ops.classmax import classmax_xla
    from shine_tpu.ops.classmax_triton import classmax_triton
    from shine_tpu.ops.packing import NEG

    n_pad, w, cls = 1024, 96, 64
    n, B = (1000, 32) if shape == "ragged_n" else (1024, 40)
    vals = rng.integers(-3, 4, size=(n_pad, w)).astype(np.float32)
    vals[n:] = 0.0
    vals[n:, 0] = NEG  # the ext table's pad-row convention
    ext = jnp.asarray(vals, jnp.bfloat16)
    q = rng.integers(-2, 3, size=(B, w)).astype(np.float32)
    q[:, 0] = 1.0
    q = jnp.asarray(q, jnp.bfloat16)
    got = classmax_triton(ext, q, cls=cls, keep2=keep2, tq=16, tc=32,
                          interpret=True)
    want = classmax_xla(ext, q, cls=cls, keep2=keep2, tn=256)
    assert len(got) == len(want)
    for g, x in zip(got, want):
        assert g.shape == (B, cls)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))


def test_scan_engine_cpu_is_xla():
    from shine_tpu.ops.classmax import scan_engine

    assert jax.devices()[0].platform == "cpu"
    assert scan_engine() == "xla"


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


def test_scan_engine_unknown_platform_raises(monkeypatch):
    from shine_tpu.ops import classmax

    monkeypatch.setattr(classmax.jax, "devices",
                        lambda: [_FakeDevice("metal")])
    with pytest.raises(RuntimeError, match="no class-max scan engine"):
        classmax.scan_engine()


def test_scan_engine_gpu_is_compiled_kernel(monkeypatch):
    """On a GPU the rule names the compiled kernel, and classmax_scan
    calls it without the Pallas interpreter."""
    from shine_tpu.ops import classmax, classmax_triton

    monkeypatch.setattr(classmax.jax, "devices",
                        lambda: [_FakeDevice("gpu")])
    assert classmax.scan_engine() == "triton"
    calls = []

    def fake_kernel(ext, q_ext, **kw):
        calls.append(kw)
        return "kernel"

    monkeypatch.setattr(classmax_triton, "classmax_triton", fake_kernel)
    assert classmax.classmax_scan("ext", "q", cls=8, keep2=True) == "kernel"
    assert calls == [{"cls": 8, "keep2": True}]


def test_select_candidates_keep2_masks_empty_runner_up():
    from shine_tpu.ops.classmax import select_candidates
    from shine_tpu.ops.packing import NEG

    m1 = jnp.asarray([[5.0, 9.0, 1.0]])
    r1 = jnp.asarray([[10, 21, 32]], jnp.int32)
    m2 = jnp.asarray([[4.0, NEG, 0.5]])
    r2 = jnp.asarray([[40, 51, 62]], jnp.int32)
    cand, vals = select_candidates((m1, r1, m2, r2), 2, keep2=True)
    assert np.asarray(cand).tolist() == [[21, 10, -1, 40]]
    assert np.asarray(vals)[0, :2].tolist() == [9.0, 5.0]


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache is where it says and
    enable_compile_cache sets no other path."""
    from shine_tpu.utils import compile_cache

    monkeypatch.delenv("SHINE_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    try:
        compile_cache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_fixed_path_when_unset(monkeypatch):
    """Unset, the cache lives at the fixed <repo>/.jax_cache."""
    import os

    from shine_tpu.utils import compile_cache

    monkeypatch.delenv("SHINE_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        compile_cache.enable_compile_cache()
        got = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache")


@pytest.mark.gpu
def test_triton_kernel_compiled_on_gpu(gpu_device):
    """The compiled kernel on the card against the XLA engine."""
    from shine_tpu.ops.classmax import classmax_xla
    from shine_tpu.ops.classmax_triton import classmax_triton

    key = jax.random.PRNGKey(0)
    ext = jax.device_put(jax.random.normal(key, (65536, 160)), gpu_device)
    ext = ext.astype(jnp.bfloat16)
    q = ext[:300] + 0.01
    for keep2 in (False, True):
        got = classmax_triton(ext, q, cls=1024, keep2=keep2)
        want = classmax_xla(ext, q, cls=1024, keep2=keep2)
        tol = 1e-3 * float(jnp.abs(want[0]).max())
        assert float(jnp.abs(got[0] - want[0]).max()) <= tol
        assert float((got[1] == want[1]).mean()) >= 0.999
