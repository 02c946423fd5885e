"""Fixed-width beam (sorted candidate/result set) for batched best-first
search.

Batched replacement for the reference's MaxHeap/MinHeap pair *and* its
per-coroutine visited hashset (/root/reference/src/hnsw/heap.hh,
coroutine.hh:60): each query's working set is a sorted (dist, id, expanded)
triple of fixed width ef. The visited set is redundant here because the
beam is monotone — `beam_merge` keeps the best ef entries, so the ef-th
distance never worsens; a node evicted from the beam was worse than the
ef-th entry and can therefore never re-enter. Re-discovered nodes still
*inside* the beam are removed by an id-dedup pass during the merge (with
expanded-flag OR), so every node is expanded at most once — exactly the
reference's visited_nodes guarantee (hnsw.hh:408), at zero carried state.

Ordering is (dist, id) ascending — the reference's tie-break
(heap.hh:53-57) — so results are deterministic.

Padding convention: id = -1, dist = +inf, expanded = True (never selected
as a frontier, always sorts last).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

INF = jnp.float32(jnp.inf)


class Beam(NamedTuple):
    dists: jnp.ndarray  # (B, ef) float32, ascending
    ids: jnp.ndarray  # (B, ef) int32, -1 pad
    expanded: jnp.ndarray  # (B, ef) bool, True pad


def beam_init(batch: int, ef: int) -> Beam:
    return Beam(
        dists=jnp.full((batch, ef), INF, dtype=jnp.float32),
        ids=jnp.full((batch, ef), -1, dtype=jnp.int32),
        expanded=jnp.ones((batch, ef), dtype=jnp.bool_),
    )


def _sort_key_ids(ids: jnp.ndarray) -> jnp.ndarray:
    # -1 pad must sort after every real id; map -1 -> int32 max.
    return jnp.where(ids < 0, jnp.int32(2**31 - 1), ids)


def beam_merge(
    beam: Beam,
    cand_dists: jnp.ndarray,  # (B, K)
    cand_ids: jnp.ndarray,  # (B, K), -1 = masked out
) -> Beam:
    """Merge K candidates per query into the beam, keeping the best ef.

    Duplicate ids (a candidate already in the beam, or repeated within the
    candidate tile) are collapsed to one entry whose expanded flag is the
    OR of the copies — the no-revisit guarantee (see module docstring).
    """
    ef = beam.ids.shape[1]
    cd = jnp.where(cand_ids >= 0, cand_dists, INF)
    all_d = jnp.concatenate([beam.dists, cd], axis=1)
    all_i = jnp.concatenate([beam.ids, jnp.where(cand_ids >= 0, cand_ids, -1)], axis=1)
    all_e = jnp.concatenate(
        [beam.expanded, jnp.zeros_like(cand_ids, dtype=jnp.bool_)], axis=1
    )
    # pass 1: group same ids, expanded copies first (key2: True -> 0)
    key_e = jnp.where(all_e, 0, 1).astype(jnp.int32)
    ik, _, d, i, e = jax.lax.sort(
        (_sort_key_ids(all_i), key_e, all_d, all_i, all_e), dimension=1, num_keys=2
    )
    dup = jnp.concatenate(
        [jnp.zeros_like(ik[:, :1], dtype=jnp.bool_), ik[:, 1:] == ik[:, :-1]],
        axis=1,
    )
    d = jnp.where(dup, INF, d)
    i = jnp.where(dup, -1, i)
    e = jnp.where(dup, True, e)
    # pass 2: order by (dist, id), keep the best ef
    d, _, i, e = jax.lax.sort(
        (d, _sort_key_ids(i), i, e), dimension=1, num_keys=2
    )
    d, i, e = d[:, :ef], i[:, :ef], e[:, :ef]
    pad = i < 0
    return Beam(
        dists=jnp.where(pad, INF, d),
        ids=i,
        expanded=jnp.where(pad, True, e),
    )


def beam_frontier(beam: Beam) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pick each query's nearest unexpanded entry.

    Returns (slot (B,), frontier_id (B,), active (B,)). active is False when
    every beam entry is expanded — the fixed-shape analogue of the reference
    termination test at hnsw.hh:424-426 (since the beam *is* the candidate
    set, 'closest candidate farther than the worst top-ef entry' reduces to
    'no unexpanded entry left').
    """
    masked = jnp.where(beam.expanded, INF, beam.dists)
    slot = jnp.argmin(masked, axis=1).astype(jnp.int32)
    frontier_id = jnp.take_along_axis(beam.ids, slot[:, None], axis=1)[:, 0]
    active = ~jnp.all(beam.expanded, axis=1)
    frontier_id = jnp.where(active, frontier_id, -1)
    return slot, frontier_id, active


def beam_frontier_multi(
    beam: Beam, width: int
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pick each query's `width` nearest unexpanded entries in one step.

    The beam is sorted by distance, so the `width` nearest unexpanded
    entries are simply the first `width` unexpanded slots left-to-right —
    a cumsum, no extra sort. Expanding several frontier nodes per step
    trades strict best-first order for ~width x fewer sequential steps
    (the analogue of the reference's multi-coroutine latency hiding,
    scheduler.hh:42-96).

    Returns (slots (B, width), frontier_ids (B, width), active (B, width)).
    """
    B, ef = beam.ids.shape
    unexp = ~beam.expanded
    rank = jnp.cumsum(unexp.astype(jnp.int32), axis=1) - 1  # (B, ef)
    pick = unexp & (rank < width)
    tgt = jnp.where(pick, rank, width)
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], (B, ef))
    cols = jnp.broadcast_to(
        jnp.arange(ef, dtype=jnp.int32)[None, :], (B, ef)
    )
    slots = jnp.full((B, width + 1), 0, jnp.int32).at[rows, tgt].set(
        cols, mode="drop"
    )[:, :width]
    active = (
        jnp.zeros((B, width + 1), jnp.bool_)
        .at[rows, tgt]
        .set(True, mode="drop")[:, :width]
    )
    fids = jnp.take_along_axis(beam.ids, slots, axis=1)
    fids = jnp.where(active, fids, -1)
    return slots, fids, active


def beam_mark_expanded(beam: Beam, slot: jnp.ndarray, active: jnp.ndarray) -> Beam:
    """Mark one slot (B,) or several slots (B, E) as expanded."""
    if slot.ndim == 1:
        slot = slot[:, None]
        active = active[:, None]
    B = beam.ids.shape[0]
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], slot.shape)
    col = jnp.where(active, slot, beam.ids.shape[1])
    new_exp = beam.expanded.at[rows, col].set(True, mode="drop")
    return beam._replace(expanded=new_exp)
