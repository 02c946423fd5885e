"""Table layouts of the scan families, and their packers.

Two layouts feed the class-max scan (ops/classmax.py):

* **ext** (FastFlatIndex): one bf16 row [2v | c0 | c1] per base row, so
  that with q_ext = [q | 1 | 1] one bf16 dot gives
  score = 2<q,v> - ||v||^2, monotone in -distance (L2); IP rows hold v
  alone. The norm is residual-encoded over two columns (c0 = the
  bf16-rounded -||v||^2, c1 = its rounding remainder): ||v||^2 is the
  largest magnitude in the row, and one bf16 slot quantizes it at
  ~||v||^2 * 2^-9 — bigger than true neighbour gaps at d=128 synthetic
  scale. The pair carries ~16 mantissa bits, and every scan or re-rank
  dot picks the correction up for free. Padding rows score NEG.
* **split** (SplitFlatIndex, routed): a component table (bf16 or
  per-row symmetric int8) plus an f32 side table aux = [nrm; scl],
  score = scl * <q, comp> + nrm.

Row widths are multiples of TABLE_K, the contraction tile of the scan
(the Hopper kernel splits a row into power-of-two pieces of at least
this width).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from shine_tpu.config import METRIC_L2
from shine_tpu.ops.distance import squared_norms

NEG = -3e38  # bf16/f32-representable 'minus infinity'
TABLE_K = 32

# Split tables pad to 16384 rows so that any class count up to 16384
# (and the scan's row chunks) divides the table.
SPLIT_QUANTUM = 16384


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def ext_width(dim: int) -> int:
    """Row width of the packed ext table: d features + 2 norm columns."""
    return _round_up(dim + 2, TABLE_K)


def comp_width(dim: int) -> int:
    """Row width of the split component table (no norm columns)."""
    return _round_up(dim, TABLE_K)


def pack_ext_table(vectors: np.ndarray, metric: int, n_pad: int) -> np.ndarray:
    """Host-side packed ext table (n_pad, ext_width(d)) f32; see the
    module docstring for the row layout."""
    n, d = vectors.shape
    v = vectors.astype(np.float32)
    ext = np.zeros((n_pad, ext_width(d)), np.float32)
    if metric == METRIC_L2:
        import ml_dtypes

        ext[:n, :d] = 2.0 * v
        t = -(v * v).sum(-1)
        c0 = t.astype(ml_dtypes.bfloat16).astype(np.float32)
        ext[:n, d] = c0
        ext[:n, d + 1] = t - c0
    else:
        ext[:n, :d] = v
    ext[n:, d] = NEG  # padding rows score -inf
    return ext


def pack_ext_query(q, dp: int) -> jnp.ndarray:
    B, d = q.shape
    qe = jnp.zeros((B, dp), jnp.float32)
    qe = qe.at[:, :d].set(jnp.asarray(q, jnp.float32))
    # 1.0 in BOTH norm columns (c0 + residual; IP tables keep d+1 = 0)
    qe = qe.at[:, d].set(1.0)
    if d + 1 < dp:
        qe = qe.at[:, d + 1].set(1.0)
    return qe


def pack_ext_rows(x, sq, dp: int, metric_l2: bool) -> jnp.ndarray:
    """Device twin of pack_ext_table for one chunk of f32 rows with their
    exact squared norms `sq`; no pad rows."""
    m, d = x.shape
    row = jnp.zeros((m, dp), jnp.float32)
    if metric_l2:
        c0 = (-sq).astype(jnp.bfloat16).astype(jnp.float32)
        row = (
            row.at[:, :d].set(2.0 * x)
            .at[:, d].set(c0)
            .at[:, d + 1].set(-sq - c0)
        )
    else:
        row = row.at[:, :d].set(x)
    return row.astype(jnp.bfloat16)


@partial(jax.jit, static_argnames=("metric", "dp", "rchunk"))
def pack_ext_device(v: jnp.ndarray, *, metric: int, dp: int,
                    rchunk: int = 65536):
    """On-device ext packing of a (n, d) base (callers guarantee
    n % 4096 == 0, so there are no pad rows). scan stacks chunks straight
    into the output, so peak extra memory is one (rchunk, dp) tile. The
    norm comes from squared_norms: the residual pair is worthless unless
    -||v||^2 itself is exact f32."""
    n, d = v.shape
    rchunk = min(rchunk, n)
    while n % rchunk:
        rchunk //= 2
    xs = v.reshape(n // rchunk, rchunk, d)
    l2 = metric == METRIC_L2

    def body(_, x):
        sq = squared_norms(x) if l2 else None
        return None, pack_ext_rows(x, sq, dp, l2)

    _, ext = jax.lax.scan(body, None, xs)
    return ext.reshape(n, dp)


def pack_split_query(q: jnp.ndarray, dpc: int) -> jnp.ndarray:
    """Zero-pad f32 queries to the component width."""
    B, d = q.shape
    q = q.astype(jnp.float32)
    if d == dpc:
        return q
    return jnp.zeros((B, dpc), jnp.float32).at[:, :d].set(q)


def pack_split_tables(
    v: np.ndarray, metric: int, n_pad: int, *, comp_dtype=np.float16
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side packing: (n, d) f32 -> (comp (n_pad, dpc), aux (2, n_pad)).

    comp_dtype: np.float16 sentinel means bf16 (numpy has no bf16; rows
    are rounded via jnp at upload), np.int8 means per-row symmetric int8.
    Pad rows get nrm = NEG so they can never win a class.
    """
    n, d = v.shape
    dpc = comp_width(d)
    aux = np.zeros((2, n_pad), np.float32)
    aux[0, n:] = NEG
    aux[1, :] = 1.0
    comp = np.zeros((n_pad, dpc),
                    np.int8 if comp_dtype == np.int8 else np.float32)
    if comp_dtype == np.int8:
        s = np.abs(v).max(axis=1)
        s = np.maximum(s, 1e-30)
        qv = np.clip(np.rint(v * (127.0 / s[:, None])), -127, 127)
        comp[:n, :d] = qv.astype(np.int8)
        vq = qv * (s[:, None] / 127.0)
        if metric == METRIC_L2:
            aux[1, :n] = 2.0 * s / 127.0
            aux[0, :n] = -np.sum(vq * vq, axis=1)
        else:
            aux[1, :n] = s / 127.0
    else:
        vb = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(
            jnp.float32))
        comp[:n, :d] = vb
        if metric == METRIC_L2:
            aux[1, :n] = 2.0
            aux[0, :n] = -np.sum(vb * vb, axis=1)
    return comp, aux


@partial(jax.jit, static_argnames=("metric", "dpc", "int8", "rchunk"))
def pack_split_device(v: jnp.ndarray, *, metric: int, dpc: int,
                      int8: bool = False, rchunk: int = 65536):
    """On-device split packing (device twin of pack_split_tables; callers
    guarantee n % 4096 == 0 so there are no pad rows)."""
    n, d = v.shape
    rchunk = min(rchunk, n)
    while n % rchunk:
        rchunk //= 2
    xs = v.reshape(n // rchunk, rchunk, d)

    def body(_, x):
        c = jnp.zeros((rchunk, dpc), jnp.float32)
        if int8:
            s = jnp.maximum(jnp.max(jnp.abs(x), axis=1), 1e-30)
            qv = jnp.clip(jnp.rint(x * (127.0 / s[:, None])), -127, 127)
            c = c.at[:, :d].set(qv)
            vq = qv * (s[:, None] / 127.0)
            if metric == METRIC_L2:
                scl = 2.0 * s / 127.0
                # ranking norms: exact f32 contraction (squared_norms)
                nrm = -squared_norms(vq)
            else:
                scl = s / 127.0
                nrm = jnp.zeros_like(s)
            return None, (c.astype(jnp.int8), nrm, scl)
        xb = x.astype(jnp.bfloat16).astype(jnp.float32)
        c = c.at[:, :d].set(xb)
        if metric == METRIC_L2:
            nrm = -squared_norms(xb)
            scl = jnp.full((rchunk,), 2.0, jnp.float32)
        else:
            nrm = jnp.zeros((rchunk,), jnp.float32)
            scl = jnp.ones((rchunk,), jnp.float32)
        return None, (c.astype(jnp.bfloat16), nrm, scl)

    _, (comp, nrm, scl) = jax.lax.scan(body, None, xs)
    aux = jnp.stack([nrm.reshape(n), scl.reshape(n)])
    return comp.reshape(n, dpc), aux


def aux_routed_layout(aux: jnp.ndarray, C: int, cap: int, cls: int):
    """(2, C*cap) f32 flat aux -> (C, 2*members, cls) cluster-block aux."""
    members = cap // cls
    a = aux.reshape(2, C, members, cls)
    return jnp.moveaxis(a, 0, 1).reshape(C, 2 * members, cls)


def aux_routed_layout_chunk(aux_c: jnp.ndarray, cap: int, cls: int):
    """Per-chunk twin of aux_routed_layout: (2, rchunk) with rchunk a
    multiple of cap -> (rchunk//cap, 2*members, cls). Stacking chunk
    outputs reproduces aux_routed_layout of the concatenated flat aux
    exactly (tests/test_routed_split.py) — used inside the ingest scan
    so the flat (2, n_pad) aux and its transpose never coexist in device
    memory."""
    members = cap // cls
    rchunk = aux_c.shape[1]
    a = aux_c.reshape(2, rchunk // cap, members, cls)
    return jnp.moveaxis(a, 0, 1).reshape(rchunk // cap, 2 * members, cls)
