"""Index persistence.

The reference checkpoints each memory node's raw index image prefixed by the
allocated size (/root/reference/src/memory_node.hh:130-209), with parameters
encoded in the filename (compute_node.cc:428-430). This index is a
structure-of-arrays (graph/soa.py), so a checkpoint is simply the arrays plus
a geometry header; `RemotePtr`s stay valid across reload for the same reason
as the reference's (they are (shard,row) ids, not addresses).

Single-file `.npz` per (sharded or whole) graph. Sharded save/load writes one
file per shard like the reference writes one dump per MN.
"""

from __future__ import annotations

import json
import os

import numpy as np

from shine_tpu.config import HNSWParams
from shine_tpu.graph.soa import GraphSoA

_FORMAT_VERSION = 1


def save_graph(graph: GraphSoA, path: str) -> None:
    """Write the full SoA graph to one .npz file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header = {
        "version": _FORMAT_VERSION,
        "M": graph.params.M,
        "ef_construction": graph.params.ef_construction,
        "metric": graph.params.metric,
        "seed": graph.params.seed,
        "entry_point": int(graph.entry_point),
        "top_level": int(graph.top_level),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
            vectors=graph.vectors,
            levels=graph.levels,
            neighbors0=graph.neighbors0,
            upper_row=graph.upper_row,
            upper_neighbors=graph.upper_neighbors,
        )
    os.replace(tmp, path)


def load_graph(path: str) -> GraphSoA:
    with np.load(path) as z:
        header = json.loads(bytes(z["header"]).decode())
        if header["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {header['version']}")
        params = HNSWParams(
            M=header["M"],
            ef_construction=header["ef_construction"],
            metric=header["metric"],
            seed=header["seed"],
        )
        return GraphSoA(
            params=params,
            vectors=z["vectors"],
            levels=z["levels"],
            neighbors0=z["neighbors0"],
            upper_row=z["upper_row"],
            upper_neighbors=z["upper_neighbors"],
            entry_point=header["entry_point"],
            top_level=header["top_level"],
        )


def save_graph_sharded(graph: GraphSoA, directory: str, num_shards: int) -> None:
    """One file per shard, like the reference's per-MN dumps
    (`index_m{M}_efc{EFC}_node{i}_of{n}.dat`, compute_node.cc:428-430).
    Row-range partition matching parallel/sharded.py's layout: shard s owns
    rows [s*rows, (s+1)*rows); upper-layer tables ride with shard 0 (they
    are replicated on load anyway)."""
    os.makedirs(directory, exist_ok=True)
    n = graph.n
    rows = -(-n // num_shards)
    header = {
        "version": _FORMAT_VERSION,
        "M": graph.params.M,
        "ef_construction": graph.params.ef_construction,
        "metric": graph.params.metric,
        "seed": graph.params.seed,
        "entry_point": int(graph.entry_point),
        "top_level": int(graph.top_level),
        "num_shards": num_shards,
        "rows_per_shard": rows,
        "n": n,
    }
    for s in range(num_shards):
        lo, hi = s * rows, min((s + 1) * rows, n)
        payload = {
            "header": np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
            "vectors": graph.vectors[lo:hi],
            "levels": graph.levels[lo:hi],
            "neighbors0": graph.neighbors0[lo:hi],
            "upper_row": graph.upper_row[lo:hi],
        }
        if s == 0:
            payload["upper_neighbors"] = graph.upper_neighbors
        path = os.path.join(directory, f"shard_{s}_of_{num_shards}.npz")
        with open(path + ".tmp", "wb") as f:
            np.savez(f, **payload)
        os.replace(path + ".tmp", path)


def load_graph_sharded(directory: str) -> GraphSoA:
    with np.load(os.path.join(directory, _find_shard0(directory))) as first:
        header = json.loads(bytes(first["header"]).decode())
    S = header["num_shards"]
    parts = {"vectors": [], "levels": [], "neighbors0": [], "upper_row": []}
    upper = None
    for s in range(S):
        with np.load(
            os.path.join(directory, f"shard_{s}_of_{S}.npz")
        ) as z:
            for k in parts:
                parts[k].append(z[k])
            if s == 0:
                upper = z["upper_neighbors"]
    params = HNSWParams(
        M=header["M"],
        ef_construction=header["ef_construction"],
        metric=header["metric"],
        seed=header["seed"],
    )
    return GraphSoA(
        params=params,
        vectors=np.concatenate(parts["vectors"]),
        levels=np.concatenate(parts["levels"]),
        neighbors0=np.concatenate(parts["neighbors0"]),
        upper_row=np.concatenate(parts["upper_row"]),
        upper_neighbors=upper,
        entry_point=header["entry_point"],
        top_level=header["top_level"],
    )


def _find_shard0(directory: str) -> str:
    for f in sorted(os.listdir(directory)):
        if f.startswith("shard_0_of_") and f.endswith(".npz"):
            return f
    raise FileNotFoundError(f"no shard_0_of_*.npz under {directory}")


def index_path(root: str, name: str, params: HNSWParams, num_shards: int = 1) -> str:
    """Parameter-encoding dump filename, mirroring the reference's
    `index_m{M}_efc{EFC}_node{i}_of{n}.dat` convention
    (compute_node.cc:428-430)."""
    return os.path.join(
        root,
        f"{name}_m{params.M}_efc{params.ef_construction}_{params.metric}"
        f"_s{num_shards}.npz",
    )


def save_routed_split(idx, path: str) -> None:
    """Checkpoint a RoutedSplitIndex's clustered split tables (the 100M
    ingest is minutes of streaming; reloading is one read — the
    reference's MN dump/load, memory_node.hh:130-209). bf16 components
    are stored as a uint16 view; row_source (key, centers) rides along
    so the exact regen re-rank survives the round trip. base_dev-backed
    indexes store only the tables — reattach base_dev at load."""
    import jax.numpy as jnp

    if idx.comp.dtype == jnp.int8:  # dtype is metadata: no transfer
        comp = np.asarray(idx.comp)
        comp_tag = "int8"
    else:
        comp = np.asarray(idx.comp.view(jnp.uint16))
        comp_tag = "bf16"
    header = {
        "version": _FORMAT_VERSION,
        "kind": "routed_split",
        "n": int(idx.n),
        "dim": int(idx.dim),
        "metric": int(idx.metric),
        "cls": int(idx.cls),
        "cap": int(idx.cap),
        "comp_dtype": comp_tag,
        "has_row_source": idx.row_source is not None,
    }
    arrays = {
        "header": np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        "comp": comp,
        "aux_r": np.asarray(idx.aux_r),
        "gid": np.asarray(idx.gid),
        "centroids": np.asarray(idx.centroids),
    }
    if idx.row_source is not None:
        key, centers = idx.row_source
        arrays["rs_key"] = np.asarray(key)
        arrays["rs_centers"] = np.asarray(centers)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_routed_split(path: str, *, base_dev=None):
    """Load a RoutedSplitIndex checkpoint (see save_routed_split)."""
    import jax.numpy as jnp

    from shine_tpu.models.routed_split import RoutedSplitIndex

    with np.load(path) as z:
        header = json.loads(bytes(z["header"]).decode())
        if header["version"] != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {header['version']}"
            )
        if header.get("kind") != "routed_split":
            raise ValueError("not a routed_split checkpoint")
        comp = jnp.asarray(z["comp"])
        if header["comp_dtype"] == "bf16":
            comp = comp.view(jnp.bfloat16)
        row_source = None
        if header["has_row_source"]:
            row_source = (jnp.asarray(z["rs_key"]), jnp.asarray(z["rs_centers"]))
        sqnorms = None
        if base_dev is not None:
            sq = (
                jnp.sum(base_dev.astype(jnp.float32) ** 2, axis=1)
                if header["metric"] == 0
                else jnp.zeros(header["n"], jnp.float32)
            )
            sqnorms = sq
        return RoutedSplitIndex(
            jnp.asarray(z["centroids"]), comp, jnp.asarray(z["aux_r"]),
            jnp.asarray(z["gid"]), header["n"], header["dim"],
            header["metric"], cls=header["cls"],
            cap=header.get("cap"),  # None (pre-r3s4 files): derived
            row_source=row_source, base_dev=base_dev, sqnorms=sqnorms,
        )
