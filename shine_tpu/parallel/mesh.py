"""Device mesh helpers.

The reference's cluster topology is CNs x MNs connected by ibverbs QPs
(reference rdma-library/library/connection_manager.cc:25-100). Here
both roles collapse onto one mesh: every device holds a graph shard (the MN
role) *and* advances a slice of the query batch (the CN role); all remote
access rides collectives instead of RDMA verbs (SURVEY.md §5.8). Every
device reaches every other directly, so the mesh is 1-D and follows the
algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

SHARD_AXIS = "shard"


def shard_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the graph/query shard axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=(SHARD_AXIS,))
