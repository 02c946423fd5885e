"""Multi-device exact k-NN: row-sharded brute force over the mesh.

The simplest and strongest scaling story in the framework: each device holds
an equal row-range of the base (the MN role, memory capacity scales
linearly with chips) and scans it for the *whole* replicated query batch
at matmul rate; per-device local top-k results are merged with one
`all_gather` of (B, k) lanes — the only interconnect traffic. Compare the reference, where every
added memory node adds RDMA fan-out per query (SURVEY.md §2.11.2); here
added devices divide the scan time with a fixed, tiny merge cost.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from shine_tpu.config import METRIC_L2, metric_id
from shine_tpu.models.flat import CHUNK_QUANTUM, FlatData, flat_search
from shine_tpu.parallel.mesh import SHARD_AXIS


def _make_sharded_flat(mesh: Mesh, k: int, chunk: int, metric: int, use_bf16: bool):
    S = mesh.devices.size

    def spmd(data: FlatData, queries: jnp.ndarray):
        # local exact top-k over this chip's rows (ids are local rows)
        ld, li = flat_search(
            data, queries, k=k, chunk=chunk, metric=metric, use_bf16=use_bf16
        )
        # rebase local row ids to global ids
        my = jax.lax.axis_index(SHARD_AXIS)
        rows = data.vectors.shape[0]
        gi = jnp.where(li >= 0, li + my * rows, -1)
        # merge: all_gather (S, B, k) lanes, one top-k over S*k
        all_d = jax.lax.all_gather(ld, SHARD_AXIS)  # (S, B, k)
        all_i = jax.lax.all_gather(gi, SHARD_AXIS)
        B = queries.shape[0]
        all_d = jnp.moveaxis(all_d, 0, 1).reshape(B, S * k)
        all_i = jnp.moveaxis(all_i, 0, 1).reshape(B, S * k)
        key_i = jnp.where(all_i < 0, jnp.int32(2**31 - 1), all_i)
        dd, _, ii = jax.lax.sort((all_d, key_i, all_i), dimension=1, num_keys=2)
        return dd[:, :k], ii[:, :k]

    @jax.jit
    def run(data: FlatData, queries: jnp.ndarray):
        fn = jax.shard_map(
            spmd,
            mesh=mesh,
            in_specs=(
                FlatData(
                    vectors=P(SHARD_AXIS),
                    vectors_bf16=P(SHARD_AXIS),
                    sqnorms=P(SHARD_AXIS),
                    n=P(),
                ),
                P(),  # queries replicated
            ),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return fn(data, queries)

    return run


class ShardedFlatIndex:
    """Exact k-NN sharded over a 1-D device mesh."""

    def __init__(self, vectors: np.ndarray, mesh: Mesh, metric: str | int = "l2"):
        self.metric = metric_id(metric)
        self.mesh = mesh
        S = mesh.devices.size
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        n, dim = v.shape
        rows = -(-n // (S * CHUNK_QUANTUM)) * CHUNK_QUANTUM  # per-shard rows
        n_pad = rows * S
        if n_pad != n:
            v = np.concatenate([v, np.zeros((n_pad - n, dim), np.float32)])
        if self.metric == METRIC_L2:
            # MUST be the same device reduction FlatIndex uses (_row_sq):
            # host numpy (v*v).sum(-1) rounds differently at the last ulp
            # (~72% of rows at 64k), which flipped (dist, id) ties at the
            # k-cutoff and broke single-vs-sharded fastbuild neighbor
            # identity at 262k
            from shine_tpu.models.flat import _row_sq

            sq = np.asarray(_row_sq(jnp.asarray(v)))
        else:
            sq = np.zeros(n_pad, np.float32)
        sq = np.where(np.arange(n_pad) < n, sq, np.inf).astype(np.float32)
        row_sh = NamedSharding(mesh, P(SHARD_AXIS))
        rep = NamedSharding(mesh, P())
        vj = jax.device_put(jnp.asarray(v), row_sh)
        # `n` must mean "rows valid on this shard" inside shard_map: every
        # shard owns `rows` rows, all globally < n are valid; per-shard
        # validity is handled by the inf-padded sqnorms, so pass rows here.
        self.data = FlatData(
            vectors=vj,
            vectors_bf16=jax.device_put(jnp.asarray(v, jnp.bfloat16), row_sh),
            sqnorms=jax.device_put(jnp.asarray(sq), row_sh),
            n=jax.device_put(jnp.int32(rows), rep),
        )
        self.n, self.dim, self.rows = n, dim, rows
        self._runs: dict = {}

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        batch_size: int = 4096,
        chunk: int = 65536,
        use_bf16: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        nq, d = queries.shape
        chunk = min(chunk, self.rows)
        key = (k, chunk, use_bf16, min(batch_size, max(nq, 1)))
        if key not in self._runs:
            self._runs[key] = _make_sharded_flat(
                self.mesh, k, chunk, self.metric, use_bf16
            )
        run = self._runs[key]
        batch_size = key[3]
        rep = NamedSharding(self.mesh, P())
        out_i = np.empty((nq, k), np.int32)
        out_d = np.empty((nq, k), np.float32)
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            q = queries[lo:hi].astype(np.float32)
            if hi - lo < batch_size:
                q = np.concatenate(
                    [q, np.zeros((batch_size - (hi - lo), d), np.float32)]
                )
            dd, ii = run(self.data, jax.device_put(jnp.asarray(q), rep))
            out_d[lo:hi] = np.asarray(dd)[: hi - lo]
            out_i[lo:hi] = np.asarray(ii)[: hi - lo]
        return out_i, out_d

    def cost_counters(self, nq: int, k: int = 10, *, batch_size: int = 4096,
                      use_bf16: bool = True) -> dict:
        """Cluster-total analytic cost (reference sums per-CN counters at
        the initiator, statistics.hh:94-115): HBM work is the same table
        scan split across shards; the interconnect moves the replicated queries out and
        the per-shard (dist, id) top-k lanes back for the merge."""
        S = self.mesh.devices.size
        n_pad = self.rows * S
        batches = -(-nq // max(batch_size, 1))
        table = n_pad * self.dim * (2 if use_bf16 else 4)
        return {
            "distance_computations": nq * n_pad + (nq * 2 * k if use_bf16 else 0),
            "scanned_rows": nq * n_pad,
            "hbm_gather_bytes": batches * table
            + (nq * 2 * k * self.dim * 4 if use_bf16 else 0),
            "ici_exchange_bytes": nq * self.dim * 4 * (S - 1)
            + nq * k * 8 * (S - 1),
        }
