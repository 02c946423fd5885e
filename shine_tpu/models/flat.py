"""Brute-force k-NN: the exact streaming scan and the class-max families.

The reference exists because CPU distance computation over a large base is
too slow, so it prunes with an HNSW graph (~0.1% of points visited per
query at the cost of pointer-chasing). On an accelerator the trade flips:
a dense (B, N) distance tile runs on the tensor cores with perfectly
sequential memory reads, while graph traversal is gather-latency-bound.
So this framework ships brute force as a first-class index (the same
role brute force plays as the reference's ground-truth oracle,
compute_node.cc:578-600, promoted to the serving path).

FlatIndex streams distances in base chunks with a running top-k, so
working memory stays O(B x chunk) for any N; bf16 matmuls with f32
accumulation, then an exact f32 re-rank. FastFlatIndex and
SplitFlatIndex scan with the class-max engines (ops/classmax.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from shine_tpu.config import METRIC_L2, device_bytes, metric_id
from shine_tpu.ops.classmax import (
    classmax_scan,
    classmax_split,
    select_candidates,
)
from shine_tpu.ops.packing import (
    NEG,
    SPLIT_QUANTUM,
    comp_width,
    ext_width,
    pack_ext_device,
    pack_ext_query,
    pack_ext_table,
    pack_split_device,
    pack_split_query,
    pack_split_tables,
)


class FlatData(NamedTuple):
    vectors: jnp.ndarray  # (N_pad, d) f32, zero rows beyond n
    vectors_bf16: jnp.ndarray  # (N_pad, d) bf16
    sqnorms: jnp.ndarray  # (N_pad,) f32 (inf beyond n)
    n: jnp.ndarray  # () i32 — real row count (N_pad is a multiple of
    # CHUNK_QUANTUM so dynamic_slice never clamps and ids stay aligned)


CHUNK_QUANTUM = 1024
# class-max tables pad to this many rows (every auto class count divides)
SCAN_QUANTUM = 4096
# share of the device's memory an index may plan to hold; the rest is
# left to query batches, scan tiles and XLA's own buffers
INDEX_MEMORY_SHARE = 0.8


def fastflat_row_bytes(dim: int) -> int:
    """Device bytes per row of the exact-re-rank FastFlatIndex layout:
    f32 base + f32 norm + bf16 ext row."""
    return 4 * dim + 4 + 2 * ext_width(dim)


def shuffle_fits(n: int, dim: int) -> bool:
    """Whether the on-device shuffle's transient (one extra f32 base
    copy) fits beside a FastFlatIndex of n rows in the device's memory."""
    need = n * (fastflat_row_bytes(dim) + 4 * dim)
    return need <= INDEX_MEMORY_SHARE * device_bytes()


@jax.jit
def _row_sq(v: jnp.ndarray) -> jnp.ndarray:
    """Fused row squared-norms. MUST stay jitted: called eagerly,
    `v * v` materializes a second base-sized buffer; under jit XLA fuses
    the contraction into the row reduction. Rides squared_norms: these
    norms rank rows (re-rank term), so they must carry HIGHEST precision
    (ops/distance.py docstring)."""
    from shine_tpu.ops.distance import squared_norms

    return squared_norms(v)


@partial(
    jax.jit,
    static_argnames=("k", "chunk", "metric", "use_bf16", "rerank", "approx"),
)
def flat_search(
    data: FlatData,
    queries: jnp.ndarray,  # (B, d)
    *,
    k: int,
    chunk: int = 65536,
    metric: int = METRIC_L2,
    use_bf16: bool = True,
    rerank: int = 4,
    approx: bool = False,
):
    """Streaming exact top-k. Returns (dists (B, k), ids (B, k)).

    With use_bf16, the scan keeps rerank*k candidates (bf16 rounding can
    reorder near-ties) and the f32 re-rank picks the final k."""
    q = queries.astype(jnp.float32)
    B = q.shape[0]
    N_pad = data.vectors.shape[0]
    chunk = min(chunk, N_pad)
    if chunk % CHUNK_QUANTUM and chunk != N_pad:
        raise ValueError(f"chunk must be a multiple of {CHUNK_QUANTUM}")
    qn = jnp.sum(q * q, axis=-1)
    qc = q.astype(jnp.bfloat16) if use_bf16 else q
    base = data.vectors_bf16 if use_bf16 else data.vectors
    kk = min(max(rerank, 1) * k, N_pad) if use_bf16 else k

    def scan_chunk(off, carry, width):
        bd, bi = carry
        blk = jax.lax.dynamic_slice_in_dim(base, off, width, 0)
        bsq = jax.lax.dynamic_slice_in_dim(data.sqnorms, off, width, 0)
        # With f32 inputs (use_bf16=False — the exact path every device
        # ground truth rides) the precision arg is load-bearing: DEFAULT
        # precision may run f32 operands at bf16 or TF32 grade, and at
        # >=1M rows the top-k gaps sit below that noise, so the ground
        # truth itself would be perturbed. bf16 inputs need no precision
        # argument; it matters only for the f32 leg.
        dots = jax.lax.dot_general(
            qc, blk, (((1,), (1,)), ((), ())),
            precision=None if use_bf16 else jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        if metric == METRIC_L2:
            dd = qn[:, None] - 2.0 * dots + bsq[None, :]
        else:
            dd = 1.0 - dots
        ids = off + jax.lax.broadcasted_iota(jnp.int32, (B, width), 1)
        # mask construction padding: rows >= n, plus inf-sqnorm sentinel
        # rows (covers the IP metric, whose distance ignores sqnorms)
        dd = jnp.where((ids < data.n) & jnp.isfinite(bsq)[None, :], dd, jnp.inf)
        all_d = jnp.concatenate([bd, dd], axis=1)
        all_i = jnp.concatenate([bi, ids], axis=1)
        if approx:
            # approximate top-k (recall_target trades a tiny chance of
            # dropping a true neighbor for a cheaper reduction where the
            # backend has one; the f32 re-rank keeps survivors ordered)
            nd, sel = jax.lax.approx_max_k(-all_d, kk, recall_target=0.99)
        else:
            nd, sel = jax.lax.top_k(-all_d, kk)
        return -nd, jnp.take_along_axis(all_i, sel, axis=1)

    bd = jnp.full((B, kk), jnp.inf, jnp.float32)
    bi = jnp.full((B, kk), -1, jnp.int32)
    num_full = N_pad // chunk
    bd, bi = jax.lax.fori_loop(
        0, num_full, lambda i, c: scan_chunk(i * chunk, c, chunk), (bd, bi)
    )
    rem = N_pad - num_full * chunk
    if rem:
        bd, bi = scan_chunk(jnp.int32(num_full * chunk), (bd, bi), rem)
    if use_bf16:
        # exact f32 re-rank of the survivors
        cv = data.vectors[jnp.maximum(bi, 0)]  # (B, k, d)
        dots = jnp.einsum(
            "bd,bkd->bk", q, cv, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        if metric == METRIC_L2:
            bd = qn[:, None] - 2.0 * dots + data.sqnorms[jnp.maximum(bi, 0)]
        else:
            bd = 1.0 - dots
        bd = jnp.where(bi >= 0, bd, jnp.inf)
        order = jnp.argsort(bd, axis=1)[:, :k]
        bd = jnp.take_along_axis(bd, order, axis=1)
        bi = jnp.take_along_axis(bi, order, axis=1)
    return bd, bi


class FlatIndex:
    """Exact k-NN index (recall 1.0 by construction)."""

    def __init__(self, vectors: np.ndarray, metric: str | int = "l2"):
        self.metric = metric_id(metric)
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        n, dim = v.shape
        n_pad = -(-n // CHUNK_QUANTUM) * CHUNK_QUANTUM
        if n_pad != n:
            v = np.concatenate([v, np.zeros((n_pad - n, dim), np.float32)])
        vj = jnp.asarray(v)
        sq = (
            _row_sq(vj)
            if self.metric == METRIC_L2
            else jnp.zeros(n_pad, jnp.float32)
        )
        sq = jnp.where(jnp.arange(n_pad) < n, sq, jnp.inf)
        self.data = FlatData(
            vj, vj.astype(jnp.bfloat16), sq, jnp.int32(n)
        )
        self.n, self.dim = n, dim

    @classmethod
    def from_device(
        cls, v_dev, metric: str | int = "l2", *, with_bf16: bool = True
    ) -> "FlatIndex":
        """Build from a device-resident base without a host round trip.
        with_bf16=False aliases the bf16 slot to the f32 array (no copy) —
        for exact-only use, e.g. on-device ground truth at 10M rows where
        the extra 2.5 GB copy matters."""
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        n, dim = v_dev.shape
        n_pad = -(-n // CHUNK_QUANTUM) * CHUNK_QUANTUM
        vj = v_dev.astype(jnp.float32)
        if n_pad != n:
            vj = jnp.concatenate(
                [vj, jnp.zeros((n_pad - n, dim), jnp.float32)]
            )
        sq = (
            _row_sq(vj)
            if self.metric == METRIC_L2
            else jnp.zeros(n_pad, jnp.float32)
        )
        sq = jnp.where(jnp.arange(n_pad) < n, sq, jnp.inf)
        vb = vj.astype(jnp.bfloat16) if with_bf16 else vj
        self.data = FlatData(vj, vb, sq, jnp.int32(n))
        self.n, self.dim = n, dim
        return self

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
        out_i = np.empty((nq, k), dtype=np.int32)
        out_d = np.empty((nq, k), dtype=np.float32)
        batch_size = min(batch_size, max(nq, 1))
        for lo in range(0, nq, batch_size):
            hi = min(lo + batch_size, nq)
            q = queries[lo:hi].astype(np.float32)
            if hi - lo < batch_size:
                q = np.concatenate(
                    [q, np.zeros((batch_size - (hi - lo), d), np.float32)]
                )
            dd, ii = flat_search(
                self.data,
                jnp.asarray(q),
                k=k,
                chunk=chunk,
                metric=self.metric,
                use_bf16=use_bf16,
            )
            out_d[lo:hi] = np.asarray(dd)[: hi - lo]
            out_i[lo:hi] = np.asarray(ii)[: hi - lo]
        return out_i, out_d

    def cost_counters(self, nq: int, k: int = 10, *, batch_size: int = 4096,
                      use_bf16: bool = True) -> dict:
        """Analytic per-run cost (reference ThreadStatistics analogue,
        statistics.hh:122-141): a dense scan's costs are exact functions of
        the shapes — every query scores every row, and every batch streams
        the whole table from device memory once."""
        n_pad = int(self.data.vectors.shape[0])
        batches = -(-nq // max(batch_size, 1))
        table = n_pad * self.dim * (2 if use_bf16 else 4)
        rerank = (2 * k) * self.dim * 4 if use_bf16 else 0
        return {
            "distance_computations": nq * n_pad + (nq * 2 * k if use_bf16 else 0),
            "scanned_rows": nq * n_pad,
            "hbm_gather_bytes": batches * table + nq * rerank,
            "ici_exchange_bytes": 0,
        }


def kb_auto(n_rows: int, dim: int) -> int:
    """kb default, a recall rule measured against exact ground truth:
    kb=32 holds >=0.992 below ~1M rows at d<512, but at 1M x 128 the
    candidate margin thins (keep2 kb32 0.9914 vs kb64 1.0000), so kb
    rises to 64 once the row count crosses 1M. bf16 score near-ties
    widen with dimension: d>=512 keeps the kb=128 margin (d=960 needs
    128 for 0.988)."""
    if dim >= 512:
        return 128
    return 64 if n_rows >= 1_000_000 else 32


def keep2_auto(n_rows: int, cls: int) -> bool:
    """keep2 default, a recall rule: the per-class runner-up slot pays
    for itself once rows-per-class reaches ~500 — the regime where a
    single bf16 class slot starts losing one-decoy near-ties (at
    1M x 64 keep2 lifts recall 0.995 -> 0.9999; at rows/cls ~195 it
    changes nothing)."""
    return n_rows // max(cls, 1) >= 500


def cls_auto(n_rows: int) -> int:
    """Class-count default: 2048 classes halve the collision loss
    (~C(k,2)/cls) of 1024, except where keep2 takes over (>= ~1M rows),
    whose runner-up slot already covers the one-decoy case at 1024."""
    return 1024 if keep2_auto(n_rows, 2048) else 2048


class FastFlatIndex:
    """Near-exact brute force: the class-max scan over the packed bf16
    ext table (ops/classmax.py), then an exact f32 re-rank of the top kb
    class winners. Rows are shuffled at build so class membership is
    independent of id order (the class-collision model assumes it).
    """

    def __init__(
        self,
        vectors: np.ndarray,
        metric: str | int = "l2",
        *,
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.metric = metric_id(metric)
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = v.shape
        self.perm = None
        if shuffle:
            rng = np.random.default_rng(seed)
            self.perm = rng.permutation(n).astype(np.int32)
            v = v[self.perm]
        n_pad = -(-n // SCAN_QUANTUM) * SCAN_QUANTUM
        ext = pack_ext_table(v, self.metric, n_pad)
        self.ext = jnp.asarray(ext, dtype=jnp.bfloat16)
        self.vectors = jnp.asarray(v)
        sq = (v * v).sum(-1) if self.metric == METRIC_L2 else np.zeros(n, np.float32)
        self.sqnorms = jnp.asarray(sq.astype(np.float32))
        self.n, self.dim = n, d
        self.dp = ext.shape[1]
        self.row_source = None

    @classmethod
    def from_ext(
        cls,
        ext_dev,
        n: int,
        metric: str | int = "l2",
        *,
        dim: int | None = None,
        row_source=None,
    ) -> "FastFlatIndex":
        """Capacity mode: build from a packed bf16 score table alone —
        no f32 base in device memory, re-rank via rerank_topk_ext. The
        per-row footprint is the ext row alone. Pair with
        io/device_synth.device_synthetic_ext_dataset for beyond-base-scale
        ingestion.

        dim is the TRUE feature dimension (the ext table is padded, so it
        can't be recovered from the shape); it drives the kb auto-sizing
        threshold in search(). Defaults to the table width minus the norm
        columns — pass the real value when you have it.

        row_source=(key, centers) (io/device_synth.py row-keyed datasets)
        switches the re-rank from bf16 ext rows to EXACT f32 rows
        regenerated in-jit from the ids (ops/distance.py:
        regen_rerank_topk) — exact-re-rank recall at ext-only cost."""
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        n_pad, dp = ext_dev.shape
        assert n_pad % SCAN_QUANTUM == 0 and n <= n_pad
        self.ext = ext_dev.astype(jnp.bfloat16)
        self.vectors = None
        self.sqnorms = None
        self.perm = None
        self.row_source = row_source
        if dim is None:
            dim = dp - 2 if self.metric == METRIC_L2 else dp
        self.n, self.dim = n, dim
        self.dp = dp
        return self

    @classmethod
    def from_device(
        cls,
        v_dev,
        metric: str | int = "l2",
        *,
        shuffle: bool | None = None,
        seed: int = 0,
    ) -> "FastFlatIndex":
        """Build from a device-resident base; the packed score table is
        assembled on device in bf16 chunks (peak extra memory = the final
        ext table + one chunk). Requires n % 4096 == 0 (generate padded
        bases; the host constructor handles ragged n).

        shuffle=None shuffles the rows on device whenever the gather's
        transient (one extra f32 base copy) fits beside the index in the
        device's memory (shuffle_fits): keeping generator order
        correlates same-class decoys and costs ~0.008 recall at
        1M x 128 against the shuffling host constructor."""
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        n, d = v_dev.shape
        if n % SCAN_QUANTUM:
            raise ValueError(f"from_device requires n % {SCAN_QUANTUM} == 0")
        v = v_dev.astype(jnp.float32)
        if shuffle is None:
            shuffle = shuffle_fits(n, d)
        self.perm = None
        if shuffle:
            perm = jax.random.permutation(jax.random.PRNGKey(seed), n)
            v = v[perm]
            self.perm = np.asarray(perm).astype(np.int32)
        dp = ext_width(d)
        self.ext = pack_ext_device(v, metric=self.metric, dp=dp)
        self.vectors = v
        sq = (
            _row_sq(v)
            if self.metric == METRIC_L2
            else jnp.zeros(n, jnp.float32)
        )
        self.sqnorms = sq.astype(jnp.float32)
        self.n, self.dim = n, d
        self.dp = dp
        self.row_source = None
        return self

    def preload(self, queries: np.ndarray, *, batch_size: int = 4096):
        """Stage queries in device memory once (the reference stages
        queries in CN RAM before its timed runs,
        compute_node.cc:277-319)."""
        nq, d = queries.shape
        nq_pad = -(-nq // batch_size) * batch_size
        q_all = np.zeros((nq_pad, d), np.float32)
        q_all[:nq] = queries.astype(np.float32)
        q_dev = jnp.asarray(q_all)
        q_dev.block_until_ready()
        return q_dev, nq

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        kb: int = 0,
        batch_size: int = 4096,
        cls: int = 0,
        preloaded=None,
        with_dists: bool = True,
        keep2: bool | None = None,
        prerank: int = 0,
        megabatch: bool = False,
        approx_sel: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """kb=0 auto-sizes the re-rank margin (kb_auto); cls=0 auto-sizes
        the class count and keep2=None the per-class runner-up
        (_resolve_knobs). with_dists=False skips the distance download.
        prerank>0 trims kb -> prerank candidates before the exact f32
        re-rank using the scan's own scores (ops/distance.py:score_trim).
        megabatch=True folds the whole batch loop into ONE dispatched
        program (fast_flat_search_mega, lax.map over batches) — for
        sustained streams where the per-dispatch launch cost binds.
        approx_sel=True selects the class winners with lax.approx_max_k
        (select_candidates)."""
        if preloaded is None:
            batch_size = min(batch_size, max(len(queries), 1))
            preloaded = self.preload(queries, batch_size=batch_size)
        ids, dists = self.search_device(
            preloaded, k, kb=kb, batch_size=batch_size, cls=cls,
            keep2=keep2, prerank=prerank, megabatch=megabatch,
            approx_sel=approx_sel,
        )
        out_i = np.asarray(ids)
        out_d = np.asarray(dists) if with_dists else np.zeros_like(
            out_i, np.float32
        )
        return out_i, out_d

    def _resolve_knobs(self, kb, cls, keep2):
        rows = int(self.ext.shape[0])
        if kb <= 0:
            kb = kb_auto(rows, self.dim)
        if cls <= 0:
            cls = cls_auto(rows)
        if keep2 is None:
            keep2 = keep2_auto(rows, cls)
        return kb, cls, keep2

    def search_device(
        self,
        preloaded,
        k: int = 10,
        *,
        kb: int = 0,
        batch_size: int = 4096,
        cls: int = 0,
        keep2: bool | None = None,
        prerank: int = 0,
        megabatch: bool = True,
        approx_sel: bool = False,
    ):
        """Device-resident search: the same programs and knob rules as
        search(), but returns (ids, dists) as DEVICE arrays with the
        shuffle permutation applied on device — no host download (a
        colocated host, or results feeding further device work).
        Reference analogue: the CN keeps results in its own RAM and only
        aggregates recall (compute_node.cc:277-319)."""
        q_dev, nq = preloaded
        kb, cls, keep2 = self._resolve_knobs(kb, cls, keep2)
        assert q_dev.shape[0] % batch_size == 0
        kw = dict(
            k=k, kb=kb, cls=cls, metric=self.metric, batch=batch_size,
            keep2=keep2, n=self.n, row_source=self.row_source,
            prerank=prerank, approx_sel=approx_sel,
        )
        if megabatch and q_dev.shape[0] > batch_size:
            all_d, all_i = fast_flat_search_mega(
                self.ext, self.vectors, self.sqnorms, q_dev, **kw
            )
        else:
            parts = [
                fast_flat_search_at(
                    self.ext, self.vectors, self.sqnorms, q_dev, lo, **kw
                )
                for lo in range(0, q_dev.shape[0], batch_size)
            ]
            all_d = jnp.concatenate([p[0] for p in parts], axis=0)
            all_i = jnp.concatenate([p[1] for p in parts], axis=0)
        if self.perm is not None:
            if getattr(self, "_perm_dev", None) is None:
                self._perm_dev = jnp.asarray(self.perm)
            all_i = jnp.where(
                all_i >= 0, jnp.take(self._perm_dev, jnp.maximum(all_i, 0)),
                -1,
            )
        return all_i[:nq], all_d[:nq]

    def cost_counters(self, nq: int, k: int = 10, *, kb: int = 0,
                      batch_size: int = 4096) -> dict:
        """Analytic cost: each batch streams the packed bf16 ext table once
        through the scan; kb survivors per query are re-ranked in f32."""
        if kb <= 0:
            kb = kb_auto(int(self.ext.shape[0]), self.dim)
        n_pad = int(self.ext.shape[0])
        batches = -(-nq // max(batch_size, 1))
        return {
            "distance_computations": nq * n_pad + nq * kb,
            "scanned_rows": nq * n_pad,
            "hbm_gather_bytes": batches * int(self.ext.nbytes)
            + nq * kb * self.dim * 4,
            "ici_exchange_bytes": 0,
        }


class SplitFlatIndex:
    """Near-exact brute force on the SPLIT layout (ops/packing.py):
    component table (bf16 or int8) + one f32 (nrm, scl) pair per row,
    class-max scan (ops/classmax.classmax_split) + re-rank.

    The f32 norm carries more precision than the residual-encoded bf16
    column pair of the ext layout. comp_dtype="int8" quarters the bytes
    of an f32 row (136 B/row at d=128) and scans as an int8 GEMM; pair
    it with an exact re-rank (resident base or row_source regen) to keep
    the recall envelope.

    Reference role: the serving-scale flat scan (the promoted
    ground-truth oracle, compute_node.cc:578-600) at the reference's
    100M-rows-per-cluster class on single cards.
    """

    def __init__(
        self,
        vectors: np.ndarray,
        metric: str | int = "l2",
        *,
        comp_dtype: str = "bf16",
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.metric = metric_id(metric)
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = v.shape
        self.perm = None
        if shuffle:
            rng = np.random.default_rng(seed)
            self.perm = rng.permutation(n).astype(np.int32)
            v = v[self.perm]
        n_pad = -(-n // SPLIT_QUANTUM) * SPLIT_QUANTUM
        comp, aux = pack_split_tables(
            v, self.metric, n_pad,
            comp_dtype=np.int8 if comp_dtype == "int8" else np.float16,
        )
        self.comp = jnp.asarray(comp) if comp_dtype == "int8" else (
            jnp.asarray(comp).astype(jnp.bfloat16)
        )
        self.aux = jnp.asarray(aux)
        self.vectors = jnp.asarray(v)
        sq = (v * v).sum(-1) if self.metric == METRIC_L2 else np.zeros(
            n, np.float32
        )
        self.sqnorms = jnp.asarray(sq.astype(np.float32))
        self.n, self.dim = n, d
        self.comp_dtype = comp_dtype
        self.row_source = None

    @classmethod
    def from_device(
        cls,
        v_dev,
        metric: str | int = "l2",
        *,
        comp_dtype: str = "bf16",
        keep_base: bool = True,
    ) -> "SplitFlatIndex":
        """Build from a device-resident base (n % 4096 == 0). With
        keep_base=False the f32 base is dropped after packing (capacity
        mode; re-rank falls back to the split tables unless a row_source
        is attached afterwards)."""
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        n, d = v_dev.shape
        if n % SCAN_QUANTUM:
            raise ValueError(f"from_device requires n % {SCAN_QUANTUM} == 0")
        v = v_dev.astype(jnp.float32)
        self.perm = None
        self.comp, self.aux = pack_split_device(
            v, metric=self.metric, dpc=comp_width(d),
            int8=(comp_dtype == "int8"),
        )
        if n % SPLIT_QUANTUM:
            pad = SPLIT_QUANTUM - n % SPLIT_QUANTUM
            self.comp = jnp.concatenate(
                [self.comp, jnp.zeros((pad, self.comp.shape[1]),
                                      self.comp.dtype)]
            )
            aux_pad = jnp.concatenate([
                jnp.full((1, pad), NEG, jnp.float32),
                jnp.ones((1, pad), jnp.float32),
            ])
            self.aux = jnp.concatenate([self.aux, aux_pad], axis=1)
        if keep_base:
            self.vectors = v
            sq = (
                _row_sq(v)
                if self.metric == METRIC_L2
                else jnp.zeros(n, jnp.float32)
            )
            self.sqnorms = sq.astype(jnp.float32)
        else:
            self.vectors = None
            self.sqnorms = None
        self.n, self.dim = n, d
        self.comp_dtype = comp_dtype
        self.row_source = None
        return self

    @classmethod
    def from_parts(
        cls,
        comp_dev,
        aux_dev,
        n: int,
        metric: str | int = "l2",
        *,
        dim: int | None = None,
        row_source=None,
    ) -> "SplitFlatIndex":
        """Capacity mode: adopt pre-packed split tables (e.g. from
        io/device_synth streaming ingestion). row_source=(key, centers)
        switches re-ranking to EXACT f32 regen (regen_rerank_topk)."""
        self = cls.__new__(cls)
        self.metric = metric_id(metric)
        n_pad, dpc = comp_dev.shape
        assert n_pad % SCAN_QUANTUM == 0 and n <= n_pad
        assert aux_dev.shape == (2, n_pad)
        self.comp = comp_dev
        self.aux = aux_dev
        self.vectors = None
        self.sqnorms = None
        self.perm = None
        self.row_source = row_source
        self.n = n
        self.dim = dim if dim is not None else dpc
        self.comp_dtype = "int8" if comp_dev.dtype == jnp.int8 else "bf16"
        return self

    preload = FastFlatIndex.preload

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        kb: int = 0,
        batch_size: int = 4096,
        cls: int = 0,
        preloaded=None,
        with_dists: bool = True,
        keep2: bool | None = None,
        prerank: int = 0,
        megabatch: bool = False,
        approx_sel: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Same knobs as FastFlatIndex.search. With an EXACT re-rank
        downstream the scan's only loss is same-class decoys, so at large
        rows-per-class the rule takes keep2-off at cls=4096 (the same
        collision loss as keep2 at half the classes, without the runner-up
        state); without an exact re-rank keep2 remains the precision
        backstop (keep2_auto)."""
        kb, cls, keep2 = self._resolve_knobs(kb, cls, keep2)
        nq, d = queries.shape
        batch_size = min(batch_size, max(nq, 1))
        if preloaded is not None:
            q_dev, nq_real = preloaded
            assert nq_real == nq and q_dev.shape[0] % batch_size == 0
        else:
            q_dev, _ = self.preload(queries, batch_size=batch_size)
        kw = dict(
            k=k, kb=kb, cls=cls, metric=self.metric, batch=batch_size,
            keep2=keep2, n=self.n, row_source=self.row_source,
            prerank=prerank, approx_sel=approx_sel,
        )
        args = (self.comp, self.aux, self.vectors, self.sqnorms, q_dev)
        if megabatch and q_dev.shape[0] > batch_size:
            all_d, all_i = split_flat_search_mega(*args, **kw)
        else:
            parts = [
                split_flat_search_at(*args, lo, **kw)
                for lo in range(0, q_dev.shape[0], batch_size)
            ]
            all_d = jnp.concatenate([p[0] for p in parts], axis=0)
            all_i = jnp.concatenate([p[1] for p in parts], axis=0)
        out_i = np.asarray(all_i)[:nq]
        out_d = np.asarray(all_d)[:nq] if with_dists else np.zeros(
            (nq, k), np.float32
        )
        if self.perm is not None:
            out_i = np.where(out_i >= 0, self.perm[np.maximum(out_i, 0)], -1)
        return out_i, out_d

    def _resolve_knobs(self, kb, cls, keep2):
        if kb <= 0:
            kb = 32 if self.dim < 512 else 128
        rows = int(self.comp.shape[0])
        exact_rerank = self.row_source is not None or self.vectors is not None
        if cls <= 0:
            if exact_rerank and keep2 is None and keep2_auto(rows, 2048):
                cls, keep2 = 4096, False
            else:
                cls = cls_auto(rows)
        if keep2 is None:
            keep2 = keep2_auto(rows, cls)
        return kb, cls, keep2

    def cost_counters(self, nq: int, k: int = 10, *, kb: int = 0,
                      batch_size: int = 4096) -> dict:
        if kb <= 0:
            kb = 32 if self.dim < 512 else 128
        n_pad = int(self.comp.shape[0])
        batches = -(-nq // max(batch_size, 1))
        table = int(self.comp.nbytes) + int(self.aux.nbytes)
        return {
            "distance_computations": nq * n_pad + nq * kb,
            "scanned_rows": nq * n_pad,
            "hbm_gather_bytes": batches * table + nq * kb * self.dim * 4,
            "ici_exchange_bytes": 0,
        }


_SCAN_STATIC = (
    "k", "kb", "cls", "metric", "batch", "keep2", "n", "prerank", "approx_sel",
)


def _rerank(cand, vals, q, *, k, metric, prerank, vectors, sqnorms,
            row_source, table_rerank):
    """Shared tail of the scan families: optional FREE stage-1 trim from
    the scan's own scores (ops/distance.py:score_trim — no table
    re-read), then the exact f32 re-rank against the resident base, or
    regenerated rows (row_source), or else the packed table
    (table_rerank(cand))."""
    from shine_tpu.ops.distance import (
        regen_rerank_topk,
        rerank_topk,
        score_trim,
    )

    exact = vectors is not None or row_source is not None
    if prerank and exact and max(prerank, k) < cand.shape[-1]:
        cand = score_trim(vals, cand, max(prerank, k))
    if vectors is not None:
        return rerank_topk(vectors, sqnorms, q, cand, k, metric)
    if row_source is not None:
        rkey, centers = row_source
        return regen_rerank_topk(rkey, centers, q, cand, k, metric)
    return table_rerank(cand)


@partial(jax.jit, static_argnames=_SCAN_STATIC)
def split_flat_search_at(
    comp, aux, vectors, sqnorms, q_dev, lo, *, k, kb, cls, metric, batch,
    keep2=False, n=0, row_source=None, prerank=0, approx_sel=False,
):
    """One fused program on the split layout: slice queries, pad to the
    component width, class-max scan, select, re-rank.

    q_dev=None means self-sweep (the queries ARE the base rows, layer-0
    kNN of the graph build): the slice comes from `vectors`, so the base
    is not passed as two program parameters."""
    qj = jax.lax.dynamic_slice_in_dim(
        vectors if q_dev is None else q_dev, lo, batch, 0
    )
    return _split_flat_batch(
        comp, aux, vectors, sqnorms, qj, k=k, kb=kb, cls=cls,
        metric=metric, keep2=keep2, n=n, row_source=row_source,
        prerank=prerank, approx_sel=approx_sel,
    )


@partial(jax.jit, static_argnames=_SCAN_STATIC)
def split_flat_search_mega(
    comp, aux, vectors, sqnorms, q_dev, *, k, kb, cls, metric, batch,
    keep2=False, n=0, row_source=None, prerank=0, approx_sel=False,
):
    """The split twin of fast_flat_search_mega: the whole query stream as
    ONE lax.map program (bit-identical to the per-batch loop, tests)."""
    assert q_dev.shape[0] % batch == 0, (
        f"mega path needs rows % batch == 0 (got {q_dev.shape[0]} % {batch});"
        " pad the query stream like FastFlatIndex.preload does"
    )
    L = q_dev.shape[0] // batch
    qs = q_dev.reshape(L, batch, q_dev.shape[1])

    def body(qj):
        return _split_flat_batch(
            comp, aux, vectors, sqnorms, qj, k=k, kb=kb, cls=cls,
            metric=metric, keep2=keep2, n=n, row_source=row_source,
            prerank=prerank, approx_sel=approx_sel,
        )

    d, i = jax.lax.map(body, qs)
    return d.reshape(L * batch, -1), i.reshape(L * batch, -1)


def _split_flat_batch(
    comp, aux, vectors, sqnorms, qj, *, k, kb, cls, metric, keep2=False,
    n=0, row_source=None, prerank=0, approx_sel=False,
):
    from shine_tpu.ops.distance import rerank_topk_split

    out = classmax_split(
        comp, aux, pack_split_query(qj, comp.shape[1]), cls=cls, keep2=keep2
    )
    cand, vals = select_candidates(out, kb, keep2, approx_sel)
    limit = n or comp.shape[0]
    cand = jnp.where(cand < limit, cand, -1)
    return _rerank(
        cand, vals, qj, k=k, metric=metric, prerank=prerank,
        vectors=vectors, sqnorms=sqnorms, row_source=row_source,
        table_rerank=lambda c: rerank_topk_split(comp, aux, qj, c, k, metric),
    )


@partial(jax.jit, static_argnames=_SCAN_STATIC)
def fast_flat_search_at(
    ext, vectors, sqnorms, q_dev, lo, *, k, kb, cls, metric, batch,
    keep2=False, n=0, row_source=None, prerank=0, approx_sel=False,
):
    """One fused program: slice the preloaded queries, pack the extended
    query, scan, select, re-rank — a single dispatch per batch.

    q_dev=None: self-sweep — slice from `vectors` (see
    split_flat_search_at)."""
    qj = jax.lax.dynamic_slice_in_dim(
        vectors if q_dev is None else q_dev, lo, batch, 0
    )
    return fast_flat_search(
        ext, vectors, sqnorms, qj, k=k, kb=kb, cls=cls, metric=metric,
        keep2=keep2, n=n, row_source=row_source, prerank=prerank,
        approx_sel=approx_sel,
    )


def fast_flat_search(
    ext, vectors, sqnorms, q, *, k, kb, cls, metric, keep2=False, n=0,
    row_source=None, prerank=0, approx_sel=False,
):
    """Class-max scan of the ext table for f32 queries q, top-kb class
    select, re-rank. Returns (dists (B, k), ids (B, k))."""
    from shine_tpu.ops.distance import rerank_topk_ext

    q_ext = pack_ext_query(q, ext.shape[1]).astype(jnp.bfloat16)
    out = classmax_scan(ext, q_ext, cls=cls, keep2=keep2)
    cand, vals = select_candidates(out, kb, keep2, approx_sel)
    limit = n or ext.shape[0]
    cand = jnp.where(cand < limit, cand, -1)
    return _rerank(
        cand, vals, q, k=k, metric=metric, prerank=prerank,
        vectors=vectors, sqnorms=sqnorms, row_source=row_source,
        table_rerank=lambda c: rerank_topk_ext(ext, q, c, k, metric),
    )


@partial(jax.jit, static_argnames=_SCAN_STATIC)
def fast_flat_search_mega(
    ext, vectors, sqnorms, q_dev, *, k, kb, cls, metric, batch,
    keep2=False, n=0, row_source=None, prerank=0, approx_sel=False,
):
    """The whole query stream in ONE dispatch: `lax.map` over (L, batch)
    query slabs, so the per-batch launch cost disappears from sustained
    streams. Same per-batch program as fast_flat_search, bit-identical
    outputs (tests)."""
    assert q_dev.shape[0] % batch == 0, (
        f"mega path needs rows % batch == 0 (got {q_dev.shape[0]} % {batch});"
        " pad the query stream like FastFlatIndex.preload does"
    )
    L = q_dev.shape[0] // batch
    qs = q_dev.reshape(L, batch, q_dev.shape[1])

    def body(qj):
        return fast_flat_search(
            ext, vectors, sqnorms, qj, k=k, kb=kb, cls=cls, metric=metric,
            keep2=keep2, n=n, row_source=row_source, prerank=prerank,
            approx_sel=approx_sel,
        )

    d, i = jax.lax.map(body, qs)
    return d.reshape(L * batch, -1), i.reshape(L * batch, -1)
