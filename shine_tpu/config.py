"""Index and search configuration.

Mirrors the reference's two-layer flag system (IndexConfiguration,
/root/reference/src/common/configuration.hh:56-113) as plain dataclasses.
Defaults follow the reference harness: M=32, ef_construction=500, k=10
(/root/reference/scripts/config.py:8-9).
"""

from __future__ import annotations

import dataclasses
import math
import os

METRIC_L2 = 0  # squared L2, matching reference distance.hh:80-118
METRIC_IP = 1  # 1 - <a,b>, matching reference distance.hh:139

_METRIC_NAMES = {"l2": METRIC_L2, "ip": METRIC_IP}

# The routed -> split boundary of --index auto is a recall rule: the
# routed split layout (models/routed_split.py) holds the reference's
# >=0.95 operating point (scripts/datasets.py:13-20) through ~64M rows per
# device (41.9M measures 0.955), while at 100M its nearest-assignment
# coverage tops out at 0.91; above it only the exact int8 split scan
# keeps >=0.95. The fastflat ceiling is a memory rule (fastflat_max_rows).
# Env overrides: SHINE_AUTO_FASTFLAT_MAX, SHINE_AUTO_ROUTED_MAX.
AUTO_ROUTED_MAX_ROWS = 64e6


def device_bytes() -> int:
    """Bytes one device may hold: SHINE_HBM_BYTES when set, else the
    device's own memory_stats()["bytes_limit"]. A device that reports no
    limit (the CPU backend) is an error unless the override is set."""
    env = os.environ.get("SHINE_HBM_BYTES")
    if env:
        return int(float(env))
    import jax

    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"{dev.platform} device reports no memory bytes_limit; "
            "set SHINE_HBM_BYTES"
        )
    return int(stats["bytes_limit"])


def fastflat_max_rows(dim: int) -> int:
    """Rows per device the exact-re-rank fastflat layout may hold."""
    from shine_tpu.models.flat import INDEX_MEMORY_SHARE, fastflat_row_bytes

    return int(INDEX_MEMORY_SHARE * device_bytes() / fastflat_row_bytes(dim))


def auto_index_family(n_rows: int, dim: int, shards: int = 1) -> str:
    """The --index auto rule: the fastest family that fits the device
    and whose recall envelope clears the reference's 0.95 operating
    point at this many rows per device."""
    per_chip = n_rows / max(shards, 1)
    env_f = os.environ.get("SHINE_AUTO_FASTFLAT_MAX")
    fmax = float(env_f) if env_f else fastflat_max_rows(dim)
    rmax = float(os.environ.get("SHINE_AUTO_ROUTED_MAX",
                                AUTO_ROUTED_MAX_ROWS))
    if per_chip <= fmax:
        return "fastflat"
    if per_chip <= rmax:
        return "routed"
    return "split"


def metric_id(metric: str | int) -> int:
    if isinstance(metric, int):
        if metric not in (METRIC_L2, METRIC_IP):
            raise ValueError(f"unknown metric id {metric}")
        return metric
    try:
        return _METRIC_NAMES[metric.lower()]
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}; expected 'l2' or 'ip'") from None


@dataclasses.dataclass(frozen=True)
class HNSWParams:
    """Build-time parameters of the graph.

    Reference semantics (/root/reference/src/hnsw/hnsw.hh:25-38):
    M_max = M for upper layers, M_max0 = 2M for layer 0,
    m_L = 1/ln(M) for the geometric level draw.
    """

    M: int = 32
    ef_construction: int = 500
    metric: str = "l2"
    seed: int = 42

    @property
    def M_max(self) -> int:
        return self.M

    @property
    def M_max0(self) -> int:
        return 2 * self.M

    @property
    def m_L(self) -> float:
        return 1.0 / math.log(self.M)

    @property
    def metric_id(self) -> int:
        return metric_id(self.metric)


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Query-time parameters.

    ef: beam width of the layer-0 best-first search
    (reference hnsw.hh:253-307); k: result count; frontier: how many
    unexpanded beam entries are expanded per traversal step (the batching
    analogue of the reference's in-flight coroutines, scheduler.hh:42-96 —
    1 is strict best-first, larger trades extra distance computations for
    ~frontier x fewer sequential steps); max_steps bounds the fixed-shape
    traversal loop (a query terminates early when its beam has no
    unexpanded candidate, matching the reference termination rule at
    hnsw.hh:424-426).
    """

    k: int = 10
    ef: int = 128
    frontier: int = 4
    max_steps: int = 0  # 0 -> auto
    entry_mode: str = "dense"  # "dense": one (B, U) matmul tile over the
    # upper-level vertices seeds the layer-0 beam with the global best
    # entries (strictly better than greedy descent, no descent loops);
    # "descent": the reference's greedy per-level walk (hnsw.hh:331-393)
    entry_seeds: int = 2  # beam seeds taken from the dense entry stage
    term: str = "ef"  # layer-0 termination rule: "ef" = the reference's
    # stop (every beam entry expanded, hnsw.hh:424-426); "k" = stop once
    # each query's top-k beam prefix is expanded — query-adaptive early
    # exit for the lockstep batch (the while_loop otherwise runs to the
    # LAGGARD query's ef-convergence; profile_hnsw step-ladder). Trades
    # a little tail recall for fewer sequential steps.
    exchange: str = "dense"  # sharded-search exchange pattern: "dense" =
    # all_gather + psum_scatter owner-compute (O(S*B*K) lanes/step);
    # "compact" = bucketed all_to_all owner RPC (O(B*K) lanes/step, exact
    # multi-round overflow) — parallel/sharded.py:_owner_rpc
    exchange_slack: float = 2.0  # compact bucket capacity = slack x
    # expected uniform per-destination load; lower forces more RPC rounds
    adaptive_slack: bool = False  # compact mode: probe the slack ladder
    # {1, 1.5, 2} on live batches and serve at the measured-min wire-byte
    # level (parallel/sharded.py:SlackController — the doorbell batch
    # sized to the actual WR count, batched_read.hh:28-60). Results are
    # identical at any slack (overflow re-queues exactly); only the
    # bucket shape and round count change.

    def resolved(self) -> "SearchParams":
        if self.frontier < 1:
            raise ValueError("frontier must be >= 1")
        if self.entry_mode not in ("dense", "descent"):
            raise ValueError("entry_mode must be 'dense' or 'descent'")
        if self.term not in ("ef", "k"):
            raise ValueError("term must be 'ef' or 'k'")
        if self.exchange not in ("dense", "compact"):
            raise ValueError("exchange must be 'dense' or 'compact'")
        ms = self.max_steps or (2 * ((self.ef + 31) // self.frontier) + 8)
        if self.k > self.ef:
            raise ValueError("k must be <= ef")
        return dataclasses.replace(self, max_steps=ms)


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()
