"""Class-max scan: the brute-force scan behind the flat scan families.

Every base row belongs to one of `cls` classes (class = row % cls), and
the scan keeps, per query, the best (score, row) of every class — and,
with keep2, the class runner-up too. Outputs are (B, cls), independent
of N, so the select that follows (lax.top_k over the class lanes) is
cheap and the exact f32 re-rank of the top kb class winners recovers
the final order. Ties keep the earliest row: per class the scan returns
the top rows by (score desc, row asc).

Recall model: a true top-k row is lost only if a better top-k row shares
its class, ~C(k,2)/cls per query at k=10; keep2 recovers the one-decoy
case, which dominates once rows-per-class is large (bf16 scores put many
decoys within the quantization of a true neighbour).

Two engines compute the same result:

* "xla": `lax.scan` over row chunks, one bf16 `dot_general` with f32
  accumulation per chunk, then the class reduce. It is the reference,
  the CPU engine, and the split-layout engine (int8 x int8 -> int32).
* "triton": the fused Hopper kernel (ops/classmax_triton.py), which keeps
  the scores in registers instead of writing each (B, chunk) f32 tile
  to device memory and reading it back.

`scan_engine()` is the one rule that picks between them.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from shine_tpu.ops.packing import NEG

# The engine the card runs. Measured by chip_smoke.py on an H100 (700 W)
# at 10M x 128 rows, 4096 queries, cls=1024: the fused kernel took
# 35.3 ms (keep2) and 22.5 ms (keep1) against the XLA engine's 361.5 ms
# and 191.9 ms, with identical outputs.
GPU_ENGINE = "triton"

# Bytes of the (B, chunk) f32 score tile the XLA engine materializes per
# step. On the H100 a 256 MB tile ran 1.6x faster than 64 MB and 2.5x
# faster than 32 MB: fewer, larger GEMMs beat staying inside L2.
XLA_TILE_BYTES = 256 << 20


def scan_engine() -> str:
    """The backend rule for the class-max scan: the measured engine on a
    GPU, the XLA engine on the CPU (tests), and an error anywhere else.
    No path reaches a Pallas interpreter: kernel tests ask for it
    themselves."""
    platform = jax.devices()[0].platform
    if platform == "gpu":
        return GPU_ENGINE
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no class-max scan engine for platform {platform!r}")


def _chunk_rows(B: int, n_pad: int, cls: int) -> int:
    """Rows per XLA scan step: cls * 2^j, dividing n_pad, with the
    (B, chunk) f32 tile under XLA_TILE_BYTES."""
    tn = cls
    while (n_pad % (2 * tn) == 0
           and B * 2 * tn * 4 <= XLA_TILE_BYTES):
        tn *= 2
    return tn


def _sweep(score_chunk, n_pad: int, B: int, cls: int, tn: int, keep2: bool):
    """Shared class reducer. score_chunk(c) -> (B, tn) f32 scores of rows
    [c*tn, (c+1)*tn). State: best score and member code per class (and
    the runner-up pair); row = code * cls + lane at the end."""
    members = tn // cls
    midx = jax.lax.broadcasted_iota(jnp.int32, (B, members, cls), 1)

    def body(state, c):
        s = score_chunk(c).reshape(B, members, cls)
        m_a = jnp.max(s, axis=1)
        i_a = jnp.argmax(s, axis=1).astype(jnp.int32)  # first max wins
        code_a = c * members + i_a
        m1, r1 = state[0], state[1]
        win = m_a > m1  # strict: the earlier row keeps a tie
        n1 = jnp.where(win, m_a, m1)
        nr1 = jnp.where(win, code_a, r1)
        if not keep2:
            return (n1, nr1), None
        m2, r2 = state[2], state[3]
        s2 = jnp.where(midx == i_a[:, None, :], -jnp.inf, s)
        m_b = jnp.max(s2, axis=1)
        code_b = c * members + jnp.argmax(s2, axis=1).astype(jnp.int32)
        # union of two stable top-2 lists, the earlier one winning ties:
        # a new winner demotes the old one (vs the chunk's runner-up);
        # otherwise the chunk's best challenges the old runner-up
        keep_v = jnp.where(win, m1, m2)
        keep_r = jnp.where(win, r1, r2)
        new_v = jnp.where(win, m_b, m_a)
        new_r = jnp.where(win, code_b, code_a)
        take = new_v > keep_v
        return (n1, nr1, jnp.where(take, new_v, keep_v),
                jnp.where(take, new_r, keep_r)), None

    pair = (jnp.full((B, cls), NEG, jnp.float32), jnp.zeros((B, cls), jnp.int32))
    init = pair + pair if keep2 else pair
    state, _ = jax.lax.scan(
        body, init, jnp.arange(n_pad // tn, dtype=jnp.int32)
    )
    lane = jax.lax.broadcasted_iota(jnp.int32, (B, cls), 1)
    out = []
    for i in range(0, len(state), 2):
        out += [state[i], state[i + 1] * cls + lane]
    return tuple(out)


@partial(jax.jit, static_argnames=("cls", "keep2", "tn"))
def classmax_xla(ext, q_ext, *, cls: int, keep2: bool = False, tn: int = 0):
    """XLA engine on the ext layout. ext (n_pad, dp) bf16 with
    n_pad % cls == 0; q_ext (B, dp). Returns (best (B, cls) f32, rows
    (B, cls) i32[, best2, rows2])."""
    n_pad, dp = ext.shape
    B = q_ext.shape[0]
    assert n_pad % cls == 0, (n_pad, cls)
    tn = tn or _chunk_rows(B, n_pad, cls)
    q = q_ext.astype(jnp.bfloat16)

    def score_chunk(c):
        blk = jax.lax.dynamic_slice_in_dim(ext, c * tn, tn, 0)
        return jax.lax.dot_general(
            q, blk, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )

    return _sweep(score_chunk, n_pad, B, cls, tn, keep2)


@partial(jax.jit, static_argnames=("cls", "keep2", "tn"))
def classmax_split(comp, aux, q, *, cls: int, keep2: bool = False,
                   tn: int = 0):
    """XLA engine on the split layout: score = scl * <q, comp> + nrm.
    comp (n_pad, dpc) bf16 or int8, aux (2, n_pad) f32, q (B, dpc) f32.
    An int8 table meets per-query symmetric int8 queries in an int8 GEMM
    with int32 accumulation; the query scale joins scl after the dot."""
    n_pad, dpc = comp.shape
    B = q.shape[0]
    assert n_pad % cls == 0 and aux.shape == (2, n_pad)
    tn = tn or _chunk_rows(B, n_pad, cls)
    q = q.astype(jnp.float32)
    if comp.dtype == jnp.int8:
        s = jnp.maximum(jnp.max(jnp.abs(q), axis=1), 1e-30)
        qop = jnp.clip(jnp.rint(q * (127.0 / s[:, None])), -127, 127)
        qop = qop.astype(jnp.int8)
        qscale = (s / 127.0)[:, None]
        acc = jnp.int32
    else:
        qop = q.astype(jnp.bfloat16)
        qscale = None
        acc = jnp.float32

    def score_chunk(c):
        blk = jax.lax.dynamic_slice_in_dim(comp, c * tn, tn, 0)
        a = jax.lax.dynamic_slice_in_dim(aux, c * tn, tn, 1)
        dots = jax.lax.dot_general(
            qop, blk, (((1,), (1,)), ((), ())), preferred_element_type=acc,
        ).astype(jnp.float32)
        if qscale is not None:
            dots = dots * qscale
        return dots * a[1][None, :] + a[0][None, :]

    return _sweep(score_chunk, n_pad, B, cls, tn, keep2)


def classmax_scan(ext, q_ext, *, cls: int, keep2: bool = False):
    """The ext-layout class-max scan on the engine scan_engine() picks,
    resolved when the caller is traced."""
    if scan_engine() == "triton":
        from shine_tpu.ops.classmax_triton import classmax_triton

        return classmax_triton(ext, q_ext, cls=cls, keep2=keep2)
    return classmax_xla(ext, q_ext, cls=cls, keep2=keep2)


def select_candidates(out, kb: int, keep2: bool, approx: bool = False):
    """Top-kb class winners of a class-max output -> (cand (B, K) rows,
    vals (B, K) scan scores). keep2 appends each selected class's
    runner-up (-1 where the class had none), K = 2*kb. approx=True
    selects with lax.approx_max_k (recall_target 0.99), which backends
    without an approximate top-k run exactly."""
    m1, r1 = out[0], out[1]
    kb = min(kb, m1.shape[1])
    if approx:
        vals, sel = jax.lax.approx_max_k(m1, kb, recall_target=0.99)
    else:
        vals, sel = jax.lax.top_k(m1, kb)
    cand = jnp.take_along_axis(r1, sel, axis=1)
    if not keep2:
        return cand, vals
    v2 = jnp.take_along_axis(out[2], sel, axis=1)
    c2 = jnp.take_along_axis(out[3], sel, axis=1)
    cand = jnp.concatenate([cand, jnp.where(v2 > NEG, c2, -1)], axis=1)
    return cand, jnp.concatenate([vals, v2], axis=1)
