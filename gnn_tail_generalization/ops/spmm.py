"""Sparse neighborhood aggregation (SpMM): ``y[dst] = sum_e w_e * x[src_e]``.

This is THE hot op of the framework — the reference delegates it to DGL's
CUDA ``update_all(copy_src, sum)`` (reference ``GNN_model/GCN.py:238``)
and to torch_sparse ``adj @ x`` in label propagation
(reference ``Label_propagation_model/outcome_correlation.py:139``).

Path
----
Gather rows by sender, scale by edge weight, and ``segment_sum`` into
receivers. Edges are pre-sorted by receiver (graph/core.py), so the
reduction is a sorted-segment sum. A ``DistGraph`` (parallel/distgraph.py)
runs the ring-streamed shard_map form of the same path.

``spmm_method`` (``SPMM_METHODS``): ``gather`` runs it in float32;
``bf16_operands`` gathers bfloat16 operands and accumulates in float32
(half the gather bytes).

The VJP is the transposed-graph SpMM (dx = A^T dy), using the sender-sorted
edge view built once at graph construction; the per-edge-weight cotangent is
the SDDMM ``dw_e = dy[dst_e] . x[src_e]``.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..graph.core import Graph

SPMM_METHODS = ("gather", "bf16_operands")


def _spmm_gather(senders, receivers, w, x, n_node, bf16: bool = False):
    if bf16:
        gathered = (x.astype(jnp.bfloat16)[senders].astype(jnp.float32)
                    * w[:, None])
    else:
        gathered = x[senders] * w[:, None].astype(x.dtype)
    return jax.ops.segment_sum(
        gathered,
        receivers,
        num_segments=n_node,
        indices_are_sorted=True,
    )


def _spmm_impl(g: Graph, x, method: str):
    from ..parallel.distgraph import DistGraph, dist_spmm

    if method not in SPMM_METHODS:
        raise ValueError(f"unknown spmm method {method!r}; "
                         f"choose one of {SPMM_METHODS}")
    bf16 = method == "bf16_operands"
    if isinstance(g, DistGraph):
        # sharded path: ring-streamed shard_map SpMM. Transparent to the
        # model layer — GCNConv calls spmm() identically on a mesh.
        return dist_spmm(
            g, x, compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    return _spmm_gather(g.senders, g.receivers, g.edge_weight, x, g.n_node,
                        bf16)


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def spmm(g: Graph, x: jax.Array, method: str = "gather"):
    """y = A @ x with A[dst, src] = w_e. ``x``: [N, d] -> ``y``: [N, d]."""
    return _spmm_impl(g, x, method)


def _spmm_fwd(g, x, method):
    return _spmm_impl(g, x, method), (g, x)


def _spmm_bwd(method, res, dy):
    g, x = res
    dx = _spmm_impl(g.transpose(), dy, method).astype(x.dtype)
    # Graph cotangents are symbolic zeros: adjacency weights are structural
    # constants everywhere in this framework (normalizations, masks), so
    # spending an SDDMM on dw every backward would be pure waste. Use
    # spmm_edge_grad when edge weights must be trained.
    dg = jax.tree.map(jnp.zeros_like, g)
    return dg, dx


spmm.defvjp(_spmm_fwd, _spmm_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(3,))
def spmm_edge_grad(g: Graph, x: jax.Array, w: jax.Array,
                   method: str = "gather"):
    """SpMM with differentiable edge weights ``w`` (dst-sorted order):
    dw_e = dy[dst_e] . x[src_e] (SDDMM). For learned-edge-weight models."""
    return _spmm_impl(g.with_edge_weight(w), x, method)


def _seg_fwd(g, x, w, method):
    return _spmm_impl(g.with_edge_weight(w), x, method), (g, x, w)


def _seg_bwd(method, res, dy):
    from .sddmm import edge_dot

    g, x, w = res
    gw = g.with_edge_weight(w)
    dx = _spmm_impl(gw.transpose(), dy, method).astype(x.dtype)
    dw = edge_dot(dy[g.receivers], x[g.senders]).astype(w.dtype)
    # padding slots (appended after the n_edge real edges) point at the
    # last node; zero their cotangent or trained weights drift off 0 there
    real = jnp.arange(g.e_pad) < g.n_edge
    dw = jnp.where(real, dw, 0.0)
    dg = jax.tree.map(jnp.zeros_like, g)
    return dg, dx, dw


spmm_edge_grad.defvjp(_seg_fwd, _seg_bwd)


def spmm_normalized(g: Graph, x, norm: str = "both", method: str = "gather"):
    """DGL-style degree-normalized aggregation used by the GCN conv:
    ``D_in^-1/2 A D_out^-1/2 x`` for 'both' (GNN_model/GCN.py:205-250),
    degrees clamped to >= 1. 'left' / 'right' use 1/deg on one side."""
    if norm in ("left", "both"):
        d = jnp.clip(g.deg_out, 1.0, None)
        scale = d**-0.5 if norm == "both" else 1.0 / d
        x = x * scale[:, None].astype(x.dtype)
    y = spmm(g, x, method)
    if norm in ("right", "both"):
        d = jnp.clip(g.deg_in, 1.0, None)
        scale = d**-0.5 if norm == "both" else 1.0 / d
        y = y * scale[:, None].astype(y.dtype)
    return y
