"""Persistent XLA compilation cache.

Compiling the scan and traversal programs takes seconds to minutes; the
persistent cache stores compiled executables so repeat processes (bench
reruns, CLI invocations, sweep subprocesses) skip them. Mirrors the
reference's practice of loading prebuilt indexes rather than rebuilding
per run (memory_node.hh:130-209) — here the artifact is the program, not
the data.

Where JAX_COMPILATION_CACHE_DIR is set, JAX already keeps its cache there
and this module sets no other path; otherwise the cache lives at the
fixed <repo>/.jax_cache (a fixed path, because the path is part of the
cache's key). Opt out with SHINE_NO_COMPILE_CACHE=1.
"""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache"
)


def enable_compile_cache() -> None:
    if os.environ.get("SHINE_NO_COMPILE_CACHE") == "1":
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
