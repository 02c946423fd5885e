"""Fused class-max scan for Hopper, written in Pallas through Triton.

Unfused, XLA writes each (B, chunk) f32 score tile to device memory and
reads it back for the class reduce: 8 bytes per score against 2*dp
flops, far below the H100's bf16 ridge. This kernel keeps the scores in
registers and reads only the table.

Grid: (query tile i, class slice j). Block (i, j) owns queries
[i*tq, (i+1)*tq) and classes [j*tc, (j+1)*tc); it walks every chunk c of
cls rows and scores only its classes' rows c*cls + j*tc + [0, tc), so its
(tq, tc) running state (best score and chunk index, plus the runner-up
pair with keep2) lives in registers and the grid fills the SMs. Blocks
that run together read the same chunk, so the table streams from L2.

The row width is split into power-of-two pieces (ops/packing.TABLE_K
multiples), one `pl.dot` each, so the table needs no pad to a power of
two. Semantics match ops/classmax.classmax_xla: per class the top rows
by (score desc, row asc).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from shine_tpu.ops.packing import NEG, TABLE_K


def _pieces(width: int) -> tuple[tuple[int, int], ...]:
    """(offset, width) power-of-two pieces covering [0, width)."""
    assert width % TABLE_K == 0, width
    out, off = [], 0
    for w in (512, 256, 128, 64, 32):
        while width - off >= w:
            out.append((off, w))
            off += w
    return tuple(out)


def _kernel(q_ref, ext_ref, *out_refs, cls: int, tc: int, n_chunks: int,
            pieces, keep2: bool):
    j = pl.program_id(1)
    tq = q_ref.shape[0]
    qs = [q_ref[:, pl.ds(o, w)] for o, w in pieces]

    def body(c, state):
        r0 = c * cls + j * tc
        s = None
        for (o, w), q in zip(pieces, qs):
            d = pl.dot(q, ext_ref[pl.ds(r0, tc), pl.ds(o, w)], trans_b=True)
            s = d if s is None else s + d
        win = s > state[0]
        m1 = jnp.where(win, s, state[0])
        r1 = jnp.where(win, c, state[1])
        if not keep2:
            return m1, r1
        # sequential top-2 insert: a new best demotes the old one
        second = (s > state[2]) & ~win
        m2 = jnp.where(win, state[0], jnp.where(second, s, state[2]))
        r2 = jnp.where(win, state[1], jnp.where(second, c, state[3]))
        return m1, r1, m2, r2

    pair = (jnp.full((tq, tc), NEG, jnp.float32),
            jnp.zeros((tq, tc), jnp.int32))
    state = jax.lax.fori_loop(0, n_chunks, body, pair * (2 if keep2 else 1))
    lane = j * tc + jax.lax.broadcasted_iota(jnp.int32, (tq, tc), 1)
    for i, ref in enumerate(out_refs):
        ref[...] = state[i] * cls + lane if i % 2 else state[i]


@partial(jax.jit, static_argnames=(
    "cls", "keep2", "tq", "tc", "num_warps", "num_stages", "interpret"))
def classmax_triton(ext, q_ext, *, cls: int, keep2: bool = False,
                    tq: int = 0, tc: int = 0, num_warps: int = 0,
                    num_stages: int = 3, interpret: bool = False):
    """ext (n_pad, dp) bf16, n_pad % cls == 0, dp % TABLE_K == 0;
    q_ext (B, dp), any B (padded to the query tile). Returns (best
    (B, cls) f32, rows (B, cls) i32[, best2, rows2]).

    Default tiles are the fastest of a sweep on an H100 at 10.5M x 128,
    4096 queries, cls=1024: keep2 (tq, tc, warps) = (64, 32, 4) at
    37.7 ms (the other 64/128 x 32/64 tilings within 7%, 128 x 128
    5x slower: its state spills); keep1 (128, 64, 8) at 23.9 ms."""
    n_pad, dp = ext.shape
    B = q_ext.shape[0]
    tq = tq or (64 if keep2 else 128)
    tc = min(tc or (32 if keep2 else 64), cls)
    num_warps = num_warps or (4 if keep2 else 8)
    assert n_pad % cls == 0 and cls % tc == 0, (n_pad, cls, tc)
    b_pad = -(-B // tq) * tq
    q = q_ext.astype(jnp.bfloat16)
    if b_pad != B:
        q = jnp.concatenate([q, jnp.zeros((b_pad - B, dp), q.dtype)])
    spec = pl.BlockSpec((tq, tc), lambda i, j: (i, j))
    shapes = [jax.ShapeDtypeStruct((b_pad, cls), jnp.float32),
              jax.ShapeDtypeStruct((b_pad, cls), jnp.int32)]
    n_out = 4 if keep2 else 2
    out = pl.pallas_call(
        partial(_kernel, cls=cls, tc=tc, n_chunks=n_pad // cls,
                pieces=_pieces(dp), keep2=keep2),
        grid=(b_pad // tq, cls // tc),
        in_specs=[
            pl.BlockSpec((tq, dp), lambda i, j: (i, 0)),
            pl.BlockSpec((n_pad, dp), lambda i, j: (0, 0)),
        ],
        out_specs=[spec] * n_out,
        out_shape=shapes * (n_out // 2),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="classmax_scan",
    )(q, ext.astype(jnp.bfloat16))
    return tuple(o[:B] for o in out)
