"""DistGraph: the sharded drop-in for graph/core.Graph — the full model on a mesh.

This module makes the REAL TricksComb teacher (norms, residual tricks, SE,
Adam, eval suite) run across devices unchanged:

- ``DistGraph`` is a pytree that duck-types the ``Graph`` surface the model
  layer actually touches (``deg_in`` / ``deg_out`` row-sharded vectors and
  dispatch inside ``ops.spmm.spmm``), so ``GCNConv``/``TricksComb``/
  ``train_teacher`` need no sharding-specific code. Everything outside the
  SpMM (dense matmuls, norms, dropout, optimizer, metrics) is row-parallel
  or replicated and is partitioned automatically by GSPMD from the input
  shardings; only the SpMM carries explicit collectives via ``shard_map``.
- Edges are double-bucketed by (dst_shard, src_shard), with local row
  indices on both ends.
- The ring: at step t device k holds source shard j=(k+t)%S's feature
  block and aggregates bucket (k, j) with a gather + ``segment_sum``;
  blocks move via ``ppermute``, overlapping transfer with the local
  aggregation (the ring-attention pattern applied to neighborhood
  aggregation, SURVEY.md section 5).

Replaces (semantics): /root/reference/GNN_model/GCN.py:18-150 executed
single-device; the reference has no multi-device story at all
(SURVEY.md section 2.9).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "bkt_senders", "bkt_receivers", "bkt_weight",
        "bkt_senders_t", "bkt_receivers_t", "bkt_weight_t",
        "deg_out", "deg_in",
        "bkt_gid", "bkt_gid_t",
        "edge_src", "edge_dst", "edge_w", "edge_src_perm",
    ],
    meta_fields=[
        "n_node", "n_node_pad", "rows_per_shard", "n_shards", "e_bucket",
        "rb", "mesh", "axis", "model_axis",
    ],
)
@dataclass(frozen=True)
class DistGraph:
    """Row-sharded graph over a 1-D ``(axis,)`` mesh dimension.

    Bucket arrays are [S, S, E_b]: bucket (k, j) holds edges with dst in
    shard k (receivers local to k) and src in shard j (senders local to j);
    padding entries carry weight 0. The ``*_t`` arrays hold the same
    buckets for A^T, for the backward ring."""

    bkt_senders: jax.Array
    bkt_receivers: jax.Array
    bkt_weight: jax.Array
    #: pre-transposed bucket arrays (bucket (k,j) of A^T = bucket (j,k) of
    #: A, roles swapped), built host-side so the backward ring never
    #: re-shards [S,S,E_b] across devices
    bkt_senders_t: jax.Array
    bkt_receivers_t: jax.Array
    bkt_weight_t: jax.Array
    deg_out: jax.Array  # [n_node_pad] f32, row-sharded
    deg_in: jax.Array
    #: edge-view fields (``with_edge_view=True``): global edge ids per
    #: bucket slot (pad -> -1) plus the canonical dst-sorted global edge
    #: list, replicated. They let graph-dropout tricks draw one per-edge
    #: mask [E] and apply it CONSISTENTLY to both weight arrays (fwd +
    #: transposed).
    bkt_gid: Optional[jax.Array] = None  # [S, S, E_b] int32
    bkt_gid_t: Optional[jax.Array] = None
    edge_src: Optional[jax.Array] = None  # [E] int32, replicated
    edge_dst: Optional[jax.Array] = None  # [E] int32, dst-sorted
    edge_w: Optional[jax.Array] = None  # [E] f32
    #: canonical->src-sorted permutation: deg_out after masking uses a
    #: SORTED segment_sum. Not
    #: swapped by transpose() — masks apply to forward graphs.
    edge_src_perm: Optional[jax.Array] = None  # [E] int32
    n_node: int = 0
    n_node_pad: int = 0
    rows_per_shard: int = 0
    n_shards: int = 1
    e_bucket: int = 0
    #: n_node_pad is a multiple of n_shards * rb
    rb: int = 128
    mesh: Optional[Mesh] = None
    axis: str = "graph"
    #: optional second mesh axis: activations/SE shard their FEATURE dim
    #: over it (tensor parallel); buckets stay replicated across it
    model_axis: Optional[str] = None

    @property
    def has_edge_view(self) -> bool:
        return self.edge_src is not None

    def transpose(self) -> "DistGraph":
        """A^T: swap to the pre-built transposed bucket sets (no device
        data movement)."""
        return dataclasses.replace(
            self,
            bkt_senders=self.bkt_senders_t,
            bkt_receivers=self.bkt_receivers_t,
            bkt_weight=self.bkt_weight_t,
            bkt_senders_t=self.bkt_senders,
            bkt_receivers_t=self.bkt_receivers,
            bkt_weight_t=self.bkt_weight,
            deg_out=self.deg_in, deg_in=self.deg_out,
            bkt_gid=self.bkt_gid_t, bkt_gid_t=self.bkt_gid,
            edge_src=self.edge_dst, edge_dst=self.edge_src,
            edge_src_perm=None,
        )


def build_dist_graph(
    edge_index: np.ndarray,
    n_node: int,
    mesh: Mesh,
    edge_weight: Optional[np.ndarray] = None,
    *,
    axis: str = "graph",
    model_axis: Optional[str] = None,
    rb: int = 128,
    with_edge_view: bool = False,
    pad_multiple: int = 8,
) -> DistGraph:
    """Host-side build + device_put with the mesh's shardings. The dst-shard
    leading axis of every bucket array is sharded over ``axis``; degree
    vectors are row-sharded; rows are padded to a multiple of
    ``n_shards * rb``. ``with_edge_view=True`` additionally stores the
    canonical (dst-sorted) global edge list and per-slot global edge ids so
    graph-dropout masks can be applied in-graph (masked_dist_graph)."""
    n_shards = mesh.shape[axis]
    e = np.asarray(edge_index, np.int64)
    w = (np.ones(e.shape[1], np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32))
    # canonical edge order: dst-sorted (then src) — edge gids index this
    # order, and the edge view's receivers are sorted for segment_sum
    can = np.lexsort((e[0], e[1]))
    e = e[:, can]
    w = w[can]
    n_node_pad = _round_up(n_node, n_shards * rb)
    rows = n_node_pad // n_shards

    deg_out = np.bincount(e[0], minlength=n_node_pad).astype(np.float32)
    deg_in = np.bincount(e[1], minlength=n_node_pad).astype(np.float32)

    dst_shard = e[1] // rows
    src_shard = e[0] // rows
    counts = np.zeros((n_shards, n_shards), np.int64)
    np.add.at(counts, (dst_shard, src_shard), 1)
    e_b = max(_round_up(int(counts.max()), pad_multiple), pad_multiple)

    sl = np.zeros((n_shards, n_shards, e_b), np.int32)
    rl = np.zeros((n_shards, n_shards, e_b), np.int32)
    ws = np.zeros((n_shards, n_shards, e_b), np.float32)
    gd = (np.full((n_shards, n_shards, e_b), -1, np.int32)
          if with_edge_view else None)
    bid = dst_shard * n_shards + src_shard
    order = np.argsort(bid, kind="stable")
    eo = e[:, order]
    wo = w[order]
    bounds = np.searchsorted(bid[order], np.arange(n_shards * n_shards + 1))
    for k in range(n_shards):
        for j in range(n_shards):
            lo, hi = bounds[k * n_shards + j], bounds[k * n_shards + j + 1]
            bs = (eo[0, lo:hi] - j * rows).astype(np.int64)
            br = (eo[1, lo:hi] - k * rows).astype(np.int64)
            bw = wo[lo:hi]
            m = hi - lo
            sl[k, j, :m], rl[k, j, :m], ws[k, j, :m] = bs, br, bw
            if with_edge_view:
                gd[k, j, :m] = order[lo:hi]  # canonical edge ids

    sh_b = NamedSharding(mesh, P(axis, None, None))
    sh_v = NamedSharding(mesh, P(axis))
    sh_r = NamedSharding(mesh, P())  # replicated
    put = lambda a, sh: None if a is None else global_put(a, sh)
    # pre-transposed buckets: bucket (k,j) of A^T = (j,k) of A, swapped
    sl_t = np.swapaxes(rl, 0, 1).copy()
    rl_t = np.swapaxes(sl, 0, 1).copy()
    ws_t = np.swapaxes(ws, 0, 1).copy()
    gd_t = None if gd is None else np.swapaxes(gd, 0, 1).copy()
    return DistGraph(
        bkt_senders=put(sl, sh_b),
        bkt_receivers=put(rl, sh_b),
        bkt_weight=put(ws, sh_b),
        bkt_senders_t=put(sl_t, sh_b),
        bkt_receivers_t=put(rl_t, sh_b),
        bkt_weight_t=put(ws_t, sh_b),
        deg_out=put(deg_out, sh_v),
        deg_in=put(deg_in, sh_v),
        bkt_gid=put(gd, sh_b),
        bkt_gid_t=put(gd_t, sh_b),
        edge_src=(put(e[0].astype(np.int32), sh_r)
                  if with_edge_view else None),
        edge_dst=(put(e[1].astype(np.int32), sh_r)
                  if with_edge_view else None),
        edge_w=put(w, sh_r) if with_edge_view else None,
        edge_src_perm=(
            put(np.argsort(e[0], kind="stable").astype(np.int32), sh_r)
            if with_edge_view else None),
        n_node=n_node,
        n_node_pad=n_node_pad,
        rows_per_shard=rows,
        n_shards=n_shards,
        e_bucket=e_b,
        rb=rb,
        mesh=mesh,
        axis=axis,
        model_axis=model_axis,
    )


def dist_spmm(g: DistGraph, x: jax.Array,
              compute_dtype=jnp.float32) -> jax.Array:
    """y = A @ x, x/y row-sharded [n_node_pad, d]. Ring-streamed: blocks
    ppermute around the mesh axis while each device aggregates the matching
    (dst, src) bucket with a gather + segment_sum. ``compute_dtype``
    bfloat16 streams and gathers bf16 blocks; sums stay float32."""
    s = g.n_shards
    axis = g.axis
    assert x.shape[0] == g.n_node_pad, (
        f"x has {x.shape[0]} rows; DistGraph needs n_node_pad="
        f"{g.n_node_pad} (pad with parallel.distgraph.pad_rows_np)")

    # on a 2-D (graph x model) mesh, the feature dim rides sharded over
    # the model axis: each device ring-streams only its feature slice (the
    # aggregation is feature-wise, so no cross-feature collective).
    # Feature dims that don't divide the axis (e.g. the classes-wide last
    # layer) fall back to replicated-over-model.
    m_axis = g.model_axis
    if m_axis is not None and x.shape[1] % g.mesh.shape[m_axis] != 0:
        m_axis = None
    xspec = P(axis, m_axis)
    bspec = P(axis, None, None)

    @partial(
        shard_map, mesh=g.mesh, in_specs=(xspec, bspec, bspec, bspec),
        out_specs=xspec, check_vma=False,
    )
    def f(x_local, senders, receivers, weights):
        k = jax.lax.axis_index(axis)
        y = jnp.zeros((g.rows_per_shard, x_local.shape[1]), jnp.float32)
        blk = x_local.astype(compute_dtype)
        for t in range(s):
            j = (k + t) % s
            sl, rl, wb = (jnp.take(a[0], j, axis=0)
                          for a in (senders, receivers, weights))
            contrib = blk[sl].astype(jnp.float32) * wb[:, None]
            y = y + jax.ops.segment_sum(
                contrib, rl, num_segments=g.rows_per_shard)
            if t < s - 1:
                blk = jax.lax.ppermute(
                    blk, axis, [(i, (i - 1) % s) for i in range(s)])
        return y.astype(x_local.dtype)

    return f(x, g.bkt_senders, g.bkt_receivers, g.bkt_weight)


def dist_take_rows(g: DistGraph, h: jax.Array, idx: jax.Array) -> jax.Array:
    """Replicated gather of a FEW rows from a row-sharded [n_node_pad, d]
    array: each device contributes its local rows (others zero) and one
    psum over the graph axis assembles the full [K, d] result on every
    device. The answer to 'DistMult needs rows of ``common``
    for sampled (src, dst) pairs' (edgewise aux loss under sharding,
    trainer_node_classification.py:435-563): K is a few thousand, so the
    psum moves K*d floats instead of all-gathering the embedding table."""
    axis = g.axis
    rows = g.rows_per_shard
    m_axis = g.model_axis
    if m_axis is not None and h.shape[1] % g.mesh.shape[m_axis] != 0:
        m_axis = None

    @partial(
        shard_map, mesh=g.mesh, in_specs=(P(axis, m_axis), P()),
        out_specs=P(None, m_axis), check_vma=False,
    )
    def f(h_local, idx):
        k = jax.lax.axis_index(axis)
        local = idx.astype(jnp.int32) - k * rows
        ok = (local >= 0) & (local < rows)
        safe = jnp.clip(local, 0, rows - 1)
        vals = jnp.where(ok[:, None], h_local[safe], 0.0)
        return jax.lax.psum(vals, axis)

    return f(h, idx)


class _EdgeView:
    """Duck-typed Graph view over the canonical global edge list — exactly
    the attribute surface nn/graph_dropout's mask samplers touch (senders /
    receivers / edge_weight / e_pad / n_node). receivers are dst-sorted, so
    ``indices_are_sorted=True`` segment-sums are valid."""

    __slots__ = ("senders", "receivers", "edge_weight", "e_pad", "n_node")

    def __init__(self, g: "DistGraph"):
        assert g.has_edge_view, (
            "DistGraph was built without with_edge_view=True — rebuild it "
            "(data.prepare_sharded does this when cfg.apply_graph_dropout)")
        assert g.edge_src_perm is not None, (
            "edge view requires the FORWARD DistGraph: transpose() drops "
            "the src-sorted permutation and its edge list is no longer "
            "dst-sorted (mask samplers run sorted segment sums over it)")
        self.senders = g.edge_src
        self.receivers = g.edge_dst
        self.edge_weight = g.edge_w
        self.e_pad = g.edge_w.shape[0]
        self.n_node = g.n_node


def global_edge_view(g: "DistGraph") -> _EdgeView:
    return _EdgeView(g)


def masked_dist_graph(g: DistGraph, mask: jax.Array) -> DistGraph:
    """Apply a per-edge mask (canonical global edge order, 1 keep / 0 drop)
    to both bucket weight arrays (forward + transposed) via the per-slot
    gid maps, and recompute degrees from the surviving edges."""
    assert g.has_edge_view
    mask = jax.lax.stop_gradient(mask.astype(jnp.float32))
    ext = jnp.concatenate([jnp.ones((1,), jnp.float32), mask])

    # the gather (replicated mask, dst-shard-sharded gid slots) runs under
    # shard_map so each device scales its local slots — no ambiguous
    # sharded-gather, no collectives
    spec = P(g.axis, None, None)

    @partial(shard_map, mesh=g.mesh, in_specs=(spec, spec, P()),
             out_specs=spec, check_vma=False)
    def _scale_local(warr, gidarr, ext):
        return warr * jnp.take(ext, gidarr + 1)

    def scale(warr, gidarr):
        if warr is None:
            return None
        return jax.lax.stop_gradient(_scale_local(warr, gidarr, ext))

    assert g.edge_src_perm is not None, (
        "masked_dist_graph applies to forward graphs (transpose() drops "
        "the src-sorted permutation)")
    keep = mask * jnp.sign(jnp.abs(g.edge_w))
    deg_in = jax.lax.stop_gradient(jax.ops.segment_sum(
        keep, g.edge_dst, num_segments=g.n_node_pad,
        indices_are_sorted=True))
    perm = g.edge_src_perm
    deg_out = jax.lax.stop_gradient(jax.ops.segment_sum(
        jnp.take(keep, perm), jnp.take(g.edge_src, perm),
        num_segments=g.n_node_pad, indices_are_sorted=True))

    return dataclasses.replace(
        g,
        bkt_weight=scale(g.bkt_weight, g.bkt_gid),
        bkt_weight_t=scale(g.bkt_weight_t, g.bkt_gid_t),
        deg_in=deg_in,
        deg_out=deg_out,
    )


def comm_volume_stats(edge_index: np.ndarray, n_node: int, n_shards: int,
                      d_feat: int = 128, itemsize: int = 4,
                      rb: int = 128) -> dict:
    """Communication accounting for one ``dist_spmm`` over an S-shard ring
    vs the partition's halo lower bound (VERDICT r4 next #4).

    The ring ppermutes each device's FULL [rows_per_shard, d] feature block
    S-1 times, so the volume is deterministic (no runtime counter needed):

      ring_rows  = (S-1) * n_node_pad          rows moved per SpMM
      ring_bytes = ring_rows * d_feat * itemsize

    The information-theoretic floor for a point-to-point exchange is the
    HALO: for each (dst_shard k, src_shard j != k) bucket, shard k needs
    each distinct off-shard source row once:

      halo_rows  = sum_{k != j} |unique senders in bucket (k, j)|

    ``ring_over_halo`` = ring_rows / halo_rows is the ring's volume
    overhead. On power-law graphs at small S the halo approaches
    (S-1)/S * E_unique-ish saturation (hubs are needed by every shard), so
    the ring's dense block streaming is close to optimal precisely when
    the graph is dense/hubby per shard; the stat makes that check
    quantitative (tests/test_distgraph.py asserts it on power-law graphs
    at 2/4/8 shards).

    Returns a dict with rows/bytes for both and per-shard maxima (the ring
    is bulk-synchronous: the slowest link paces every step). Reference: none — the reference
    is single-GPU (trainer_node_classification.py:258)."""
    e = np.asarray(edge_index, np.int64)
    n_node_pad = _round_up(n_node, n_shards * rb)
    rows = n_node_pad // n_shards
    dst_shard = e[1] // rows
    src_shard = e[0] // rows
    halo_rows = 0
    halo_per_dst = np.zeros(n_shards, np.int64)
    for k in range(n_shards):
        for j in range(n_shards):
            if k == j:
                continue
            m = (dst_shard == k) & (src_shard == j)
            u = len(np.unique(e[0][m]))
            halo_rows += u
            halo_per_dst[k] += u
    ring_rows = (n_shards - 1) * n_node_pad
    return {
        "n_shards": n_shards,
        "n_node_pad": int(n_node_pad),
        "rows_per_shard": int(rows),
        "ring_rows_per_spmm": int(ring_rows),
        "ring_bytes_per_spmm": int(ring_rows * d_feat * itemsize),
        "ring_bytes_per_chip_per_spmm": int(
            (n_shards - 1) * rows * d_feat * itemsize),
        "halo_rows_lower_bound": int(halo_rows),
        "halo_bytes_lower_bound": int(halo_rows * d_feat * itemsize),
        "halo_rows_max_dst_shard": int(halo_per_dst.max()),
        "ring_over_halo": float(ring_rows / max(halo_rows, 1)),
    }


def global_put(a: np.ndarray, sharding: NamedSharding) -> jax.Array:
    """Multi-process-safe device placement: every process holds the same
    full host array (SPMD data build) and contributes only its addressable
    shards. Identical to device_put in single-process runs; required on
    multi-host meshes where no process can address every device."""
    a = np.asarray(a)
    return jax.make_array_from_callback(
        a.shape, sharding, lambda idx: a[idx])


def pad_rows_np(a: np.ndarray, n_node_pad: int, fill=0):
    pad = n_node_pad - a.shape[0]
    if pad == 0:
        return a
    return np.concatenate(
        [a, np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)


def shard_params(mesh: Mesh, params, axis: str = "graph",
                 model_axis: Optional[str] = None):
    """Canonical parameter shardings for the teacher on a graph mesh: SE
    tables (name 'se') row-sharded (and feature-sharded over model_axis on
    a 2-D mesh); dense kernels column-parallel over model_axis; everything
    else replicated."""

    m_size = mesh.shape[model_axis] if model_axis is not None else 1

    def spec(path, leaf):
        names = [p.key if hasattr(p, "key") else str(p) for p in path]
        # feature dims that don't divide the model axis (e.g. num_classes)
        # stay replicated on that axis
        feat_ok = (model_axis is not None and leaf.ndim == 2
                   and leaf.shape[1] % m_size == 0)
        if any(n == "se" for n in names):
            return jax.device_put(
                leaf, NamedSharding(
                    mesh, P(axis, model_axis if feat_ok else None)))
        if feat_ok and "kernel" in names:
            return jax.device_put(
                leaf, NamedSharding(mesh, P(None, model_axis)))
        return jax.device_put(leaf, NamedSharding(mesh, P()))

    return jax.tree_util.tree_map_with_path(spec, params)
