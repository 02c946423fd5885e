"""Batched open-addressing visited set.

Batched replacement for the per-coroutine ``visited_nodes`` hashset of the
reference (/root/reference/src/coroutine.hh:60, hnsw.hh:408): each of the B
in-flight queries owns a fixed-size, power-of-two hash table of int32 ids in
HBM with linear probing, and membership-check + insert for K candidate ids
per query is fully vectorized (P gathers + one masked scatter; no loops over
B or K).

Collision note: if two *new* candidates of the same query pick the same empty
slot in one step, one insert is lost — that id may be rechecked later, which
costs a duplicate distance computation but never corrupts results (the beam
merge still orders by (dist, id)).
"""

from __future__ import annotations

import jax.numpy as jnp


def hashset_init(batch: int, size: int) -> jnp.ndarray:
    """(B, size) table of int32, -1 = empty. size must be a power of two."""
    assert size & (size - 1) == 0, "hashset size must be a power of two"
    return jnp.full((batch, size), -1, dtype=jnp.int32)


def _mix(ids: jnp.ndarray) -> jnp.ndarray:
    """Cheap 32-bit integer hash (xorshift-multiply), like the reference's
    SplitMix64 bucket hash (cooling_table.hh:101-110) in spirit."""
    x = ids.astype(jnp.uint32)
    x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hashset_check_insert(
    table: jnp.ndarray,  # (B, V) int32
    ids: jnp.ndarray,  # (B, K) int32; -1 = invalid candidate
    *,
    probes: int = 8,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Return (new_table, is_new (B,K) bool).

    is_new[b,k] is True iff ids[b,k] >= 0 and was not present in the table;
    all such ids are inserted (modulo the benign collision note above).
    """
    B, V = table.shape
    valid = ids >= 0
    h = (_mix(ids) & jnp.uint32(V - 1)).astype(jnp.int32)  # (B, K)
    offs = jnp.arange(probes, dtype=jnp.int32)  # (P,)
    slots = (h[:, :, None] + offs[None, None, :]) & (V - 1)  # (B, K, P)
    got = jnp.take_along_axis(
        table[:, None, :], slots, axis=2
    )  # broadcast (B,1,V) gathered at (B,K,P) -> (B,K,P)
    found = jnp.any(got == ids[:, :, None], axis=2)
    # intra-call dedup: a candidate equal to an earlier candidate in the same
    # call counts as already present (K is small, the K^2 mask is cheap)
    K = ids.shape[1]
    earlier = jnp.tril(jnp.ones((K, K), dtype=jnp.bool_), k=-1)
    dup = jnp.any((ids[:, :, None] == ids[:, None, :]) & earlier[None], axis=2)
    found = found | dup
    empty = got == -1
    has_empty = jnp.any(empty, axis=2)
    first_empty = jnp.argmax(empty, axis=2)  # (B, K)
    is_new = valid & ~found
    do_insert = is_new & has_empty
    ins_slot = jnp.take_along_axis(slots, first_empty[:, :, None], axis=2)[..., 0]
    # out-of-range slot for masked-out lanes -> dropped by the scatter
    ins_slot = jnp.where(do_insert, ins_slot, V)
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], ins_slot.shape)
    new_table = table.at[rows, ins_slot].set(ids, mode="drop")
    return new_table, is_new
