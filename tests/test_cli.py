"""CLI (reference main.cc / configuration.hh analogue) and workload
generation."""

import json

import numpy as np
import pytest


def run_cli(argv, capsys):
    from shine_tpu.cli import main

    rc = main(argv)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)


def test_cli_flat_synthetic(capsys):
    doc = run_cli(
        ["--synthetic", "2000:16", "--index", "flat", "--num-queries", "100"],
        capsys,
    )
    assert doc["queries"]["recall"] == pytest.approx(1.0)
    assert doc["queries"]["num_queries"] == 100


def test_cli_hnsw_store_load(tmp_path, capsys):
    ckpt = str(tmp_path / "idx.npz")
    doc = run_cli(
        ["--synthetic", "2000:16", "--index", "hnsw", "-m", "8",
         "--ef-construction", "50", "--ef-search", "64",
         "--num-queries", "100", "--store-index", ckpt],
        capsys,
    )
    assert doc["queries"]["recall"] > 0.9
    doc2 = run_cli(
        ["--synthetic", "2000:16", "--index", "hnsw", "-m", "8",
         "--ef-construction", "50", "--ef-search", "64",
         "--num-queries", "100", "--load-index", ckpt],
        capsys,
    )
    assert doc2["queries"]["recall"] == doc["queries"]["recall"]
    assert "load_index_buffer" in doc2["timings"]


def test_cli_sharded_flat(capsys):
    doc = run_cli(
        ["--synthetic", "3000:16", "--index", "flat", "--shards", "4",
         "--num-queries", "64"],
        capsys,
    )
    assert doc["queries"]["recall"] == pytest.approx(1.0)
    assert doc["meta"]["num_shards"] == 4


def test_cli_zipf_workload(capsys):
    doc = run_cli(
        ["--synthetic", "2000:16", "--index", "flat", "--num-queries", "200",
         "--zipf", "1.0", "--warmup", "50", "--no-recall"],
        capsys,
    )
    assert doc["meta"]["zipf"] == 1.0
    assert "warmup" in doc["timings"]


def test_cli_zipf_recall_alignment(capsys):
    """Skewed workloads resample the query pool; recall must compare each
    resampled row against ITS pool row's ground truth (an exact index under
    any permutation/resampling scores 1.0 — misalignment scores ~0)."""
    doc = run_cli(
        ["--synthetic", "2000:16", "--index", "flat", "--num-queries", "200",
         "--zipf", "1.0", "--warmup", "50"],
        capsys,
    )
    assert doc["queries"]["recall"] == pytest.approx(1.0)


def test_zipf_skew_shape():
    from shine_tpu.io.skew import skewed_workload, zipf_ranks

    pool = np.arange(100, dtype=np.float32)[:, None].repeat(4, axis=1)
    w, t, idx = skewed_workload(pool, total=500, alpha=1.25, warmup=100, seed=3)
    assert w.shape == (100, 4) and t.shape == (500, 4)
    # skew: the most popular pool entry should dominate
    counts = np.bincount(idx, minlength=100)
    assert counts.max() > 5 * np.median(counts[counts > 0])
    # alpha=0 is uniform-ish
    r = zipf_ranks(100, 0.0, 5000, seed=1)
    c = np.bincount(r, minlength=100)
    assert c.max() < 3 * c.min() + 20


def test_cli_fast_build(capsys):
    doc = run_cli(
        ["--synthetic", "2000:16", "--index", "hnsw", "-m", "8",
         "--ef-construction", "50", "--ef-search", "64",
         "--num-queries", "100", "--fast-build"],
        capsys,
    )
    assert doc["queries"]["recall"] > 0.9


def test_cli_ivf_routed(capsys):
    doc = run_cli(
        ["--synthetic", "6000:16", "--index", "ivf", "--ivf-routed",
         "--probes", "8", "--ivf-shared", "48", "--ivf-tile", "64",
         "--num-queries", "200"],
        capsys,
    )
    assert doc["queries"]["recall"] > 0.9
    # routed cost counters are analytic and non-zero
    assert doc["queries"]["distance_computations"] > 0
    assert doc["queries"]["scanned_rows"] > 0


def test_cli_sharded_ivf_routed(capsys):
    doc = run_cli(
        ["--synthetic", "6000:16", "--index", "ivf", "--ivf-routed",
         "--probes", "8", "--ivf-shared", "48", "--ivf-tile", "32",
         "--shards", "4", "--num-queries", "200"],
        capsys,
    )
    assert doc["queries"]["recall"] > 0.9
    assert doc["queries"]["ici_exchange_bytes"] > 0


def test_cli_sharded_hnsw_compact_exchange(capsys):
    """--exchange compact serves over the bucketed all_to_all RPC and
    reports the measured (nonzero) interconnect byte counter."""
    doc = run_cli(
        ["--synthetic", "3000:16", "--index", "hnsw", "-m", "8",
         "--ef-construction", "50", "--ef-search", "48", "--shards", "4",
         "--num-queries", "64", "--exchange", "compact"],
        capsys,
    )
    assert doc["queries"]["recall"] > 0.9
    assert doc["queries"]["ici_exchange_bytes"] > 0


def _load_data_tools():
    import importlib.util
    import os

    path = os.path.join(
        os.path.dirname(__file__), "..", "scripts", "data_tools.py"
    )
    spec = importlib.util.spec_from_file_location("data_tools", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_data_path_end_to_end(tmp_path, capsys):
    """The on-disk ingestion path, end to end: data_tools synth writes the
    reference's directory convention (base.fbin, queries/query.fbin,
    groundtruth-query.bin — compute_node.cc:277-319), then the CLI's
    --data-path flow (load_dataset discovery -> fbin readers -> .bin GT
    alignment) must score recall 1.0 on the exact index."""
    import argparse

    dt = _load_data_tools()
    root = str(tmp_path / "synthds")
    dt.cmd_synth(
        argparse.Namespace(shape="1500:12", queries=80, seed=5, out=root)
    )
    doc = run_cli(
        ["--data-path", root, "--index", "flat", "--num-queries", "64"],
        capsys,
    )
    assert doc["queries"]["recall"] == pytest.approx(1.0)
    assert doc["queries"]["num_queries"] == 64


def test_cli_data_path_u8bin_and_row_filter(tmp_path):
    """u8bin bases widen to f32 through the same discovery chain, and the
    readers' round-robin row_filter tiles the base exactly (the
    reference's CN partitioning, io/read_data.hh:57-77)."""
    from shine_tpu.io import brute_force_knn, load_dataset, read_bin, write_bin
    from shine_tpu.io.recall import recall_at_k
    from shine_tpu.models.flat import FlatIndex

    rng = np.random.default_rng(3)
    base8 = rng.integers(0, 256, size=(1200, 16), dtype=np.uint8)
    queries = base8[rng.integers(0, 1200, 50)].astype(np.float32)
    queries += rng.normal(scale=2.0, size=queries.shape).astype(np.float32)
    gt, _ = brute_force_knn(base8.astype(np.float32), queries, 10)
    root = tmp_path / "u8ds"
    write_bin(str(root / "base.u8bin"), base8)
    write_bin(str(root / "queries" / "query.fbin"), queries)
    write_bin(str(root / "groundtruth-query.bin"), gt.astype(np.uint32))

    ds = load_dataset(str(root))
    assert ds.base.dtype == np.float32 and ds.base.shape == (1200, 16)
    ids, _ = FlatIndex(ds.base).search(ds.queries, 10, use_bf16=False)
    assert recall_at_k(ids, ds.ground_truth, 10) == pytest.approx(1.0)

    # round-robin shards reconstruct the base exactly
    parts = [
        read_bin(str(root / "base.u8bin"), row_filter=(s, 3))
        for s in range(3)
    ]
    assert sum(p.shape[0] for p in parts) == 1200
    recon = np.empty((1200, 16), np.float32)
    for s, p in enumerate(parts):
        recon[s::3] = p
    np.testing.assert_array_equal(recon, base8.astype(np.float32))


def test_cli_hnsw_quantized_rows(capsys):
    """--rows int8 serves the same build with quantized traversal rows
    (models/hnsw.py:device_graph)."""
    doc = run_cli(
        ["--synthetic", "2000:16", "--index", "hnsw", "-m", "8",
         "--ef-construction", "50", "--ef-search", "64",
         "--num-queries", "100", "--rows", "int8"],
        capsys,
    )
    assert doc["queries"]["recall"] > 0.85


def test_cli_split_synthetic(capsys):
    # int8 split capacity layout: exact re-rank from the kept base
    doc = run_cli(
        ["--synthetic", "4096:16", "--index", "split",
         "--num-queries", "100"],
        capsys,
    )
    assert doc["queries"]["recall"] > 0.95
    # int8 comp + f32 aux (lane-padded: the 136 B/row win needs d~128)
    assert doc["build"]["index_size_in_bytes"] > 0


def test_cli_routed_synthetic(capsys):
    # cluster-pruned routed serving over the split tables (base_dev
    # re-rank); shared=C at this tiny N so coverage is exact
    doc = run_cli(
        ["--synthetic", "4096:16", "--index", "routed",
         "--num-queries", "100", "--probes", "8", "--ivf-shared", "16",
         "--ivf-tile", "32", "--batch", "128"],
        capsys,
    )
    assert doc["queries"]["recall"] > 0.85


def test_cli_index_auto(capsys):
    # --index auto resolves by the measured rows-per-chip rule
    # small synthetic -> fastflat
    doc = run_cli(
        ["--synthetic", "4096:16", "--index", "auto",
         "--num-queries", "100"],
        capsys,
    )
    assert doc["queries"]["recall"] > 0.95


def test_auto_index_family_boundaries(monkeypatch):
    """The three-family rule at its edges (config.py): fastflat while its
    layout fits the device's memory, routed through 64M (the recall
    rule), exact split beyond. Shards divide the rows."""
    from shine_tpu.config import (
        AUTO_ROUTED_MAX_ROWS,
        auto_index_family,
        fastflat_max_rows,
    )

    # a 16 GB device at d=128 (836 B/row): ~16.4M fastflat rows
    monkeypatch.setenv("SHINE_HBM_BYTES", str(16 << 30))
    f, r = fastflat_max_rows(128), int(AUTO_ROUTED_MAX_ROWS)
    assert 16_000_000 < f < 17_000_000
    assert auto_index_family(f, 128) == "fastflat"
    assert auto_index_family(f + 1, 128) == "routed"
    assert auto_index_family(r, 128) == "routed"
    assert auto_index_family(r + 1, 128) == "split"
    # shards scale the per-device rows: 8 devices push the boundary out
    assert auto_index_family(8 * f, 128, shards=8) == "fastflat"
    assert auto_index_family(8 * f + 8, 128, shards=8) == "routed"
    assert auto_index_family(8 * r + 8, 128, shards=8) == "split"
    # a larger device holds more rows; the recall rule does not move
    monkeypatch.setenv("SHINE_HBM_BYTES", str(60 << 30))
    assert fastflat_max_rows(128) > 3 * f
    assert auto_index_family(r + 1, 128) == "split"


def test_device_bytes_requires_a_stated_limit(monkeypatch):
    """A device without memory_stats()["bytes_limit"] (the CPU) is an
    error for the memory-derived rules unless SHINE_HBM_BYTES states it."""
    from shine_tpu.config import device_bytes

    monkeypatch.delenv("SHINE_HBM_BYTES", raising=False)
    with pytest.raises(RuntimeError, match="bytes_limit"):
        device_bytes()
    monkeypatch.setenv("SHINE_HBM_BYTES", "1e9")
    assert device_bytes() == 1_000_000_000


def test_cli_index_auto_routed_and_split_e2e(capsys, monkeypatch):
    """End-to-end at each auto-family boundary: shrink the thresholds via
    the env overrides so a CPU-sized dataset exercises each branch."""
    monkeypatch.setenv("SHINE_AUTO_FASTFLAT_MAX", "10000")
    monkeypatch.setenv("SHINE_AUTO_ROUTED_MAX", "30000")
    doc = run_cli(
        ["--synthetic", "20000:16", "--index", "auto", "--probes", "16",
         "--ivf-shared", "32", "--ivf-tile", "32",
         "--num-queries", "64", "--batch", "64"],
        capsys,
    )
    assert doc["queries"]["recall"] > 0.85  # routed branch
    monkeypatch.setenv("SHINE_AUTO_ROUTED_MAX", "15000")
    doc = run_cli(
        ["--synthetic", "20000:16", "--index", "auto",
         "--num-queries", "64", "--batch", "64"],
        capsys,
    )
    assert doc["queries"]["recall"] > 0.95  # exact split branch


def test_cli_sharded_split(capsys):
    # --index split --shards: host base row-sharded over the CPU mesh
    # (ShardedSplitFlatIndex.from_host), ids mapped back through perm
    doc = run_cli(
        ["--synthetic", "20000:16", "--index", "split", "--shards", "4",
         "--num-queries", "64", "--batch", "64"],
        capsys,
    )
    assert doc["queries"]["recall"] > 0.9


def test_cli_sharded_routed(capsys):
    # --index routed --shards: cluster blocks dealt round-robin, exact
    # replicated-base re-rank (ShardedRoutedSplitIndex host-base mode)
    doc = run_cli(
        ["--synthetic", "20000:16", "--index", "routed", "--shards", "4",
         "--probes", "16", "--ivf-shared", "32", "--ivf-tile", "32",
         "--num-queries", "64", "--batch", "64"],
        capsys,
    )
    assert doc["queries"]["recall"] > 0.85
