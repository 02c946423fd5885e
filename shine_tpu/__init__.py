"""shine_tpu — an accelerator-native distributed HNSW index-and-query engine.

From-scratch rebuild of the capabilities of SHINE (disaggregated-memory HNSW
over one-sided RDMA; see SURVEY.md) in JAX: fixed-shape batched graph
traversal under `jax.jit`, matmul-shaped distance scans (XLA, and a
Pallas kernel for the GPU), index sharding across a `jax.sharding.Mesh`
with compute-at-data remote row gathers in place of RDMA
READs, hot-vertex replication in place of the compute-node cache, and
k-means query-to-shard routing.
"""

from shine_tpu.config import HNSWParams, SearchParams

__all__ = ["HNSWParams", "SearchParams"]
__version__ = "0.1.0"
