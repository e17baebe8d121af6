"""Outcome/residual correlation — the label-propagation hot loop.

Reference parity: ``/root/reference/Label_propagation_model/outcome_correlation.py``
- process_adj / gen_normalized_adjs (39-55): symmetric adjacency, D^-1/2,
  and the DAD / DA / AD normalizations
- general_outcome_correlation (128-145): result <- a * A @ result + (1-a) * y
  (or + y when alpha_term=False), post-step clamp, repeated num_propagations
  times
- label_propagation (147-156): one-hot train labels, DAD, clamp [0, 1]
- double_correlation_{autoscale,fixed} / only_outcome_correlation (158-213):
  the Correct & Smooth stages

The propagation loop is a ``lax.fori_loop`` over the framework SpMM, fully
jitted on the accelerator (the reference forces C&S to CPU,
LP_Adj.py:149-152).

Convention note: torch_sparse ``SparseTensor(row=e0, col=e1) @ x`` sums over
columns, i.e. out[e0] += x[e1]; the Graphs built here use receivers=e0,
senders=e1 to match.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp

from ..graph.core import Graph, build_graph, symmetrize
from ..ops.spmm import spmm


def _adj_graph(edge_index: np.ndarray, n_node: int, w: np.ndarray) -> Graph:
    # receivers = e[0], senders = e[1] (see convention note above)
    flipped = np.stack([edge_index[1], edge_index[0]])
    return build_graph(flipped, n_node, edge_weight=w)


def gen_normalized_adjs(edge_index: np.ndarray, n_node: int, which=None):
    """(DAD, DA, AD) Graphs (outcome_correlation.py:39-55). ``edge_index``
    is symmetrized first (process_adj's to_undirected); degrees are row sums
    with 0^-0.5 -> 0. ``which`` (a set of names) skips building/uploading
    the unused normalizations — each Graph is a full padded device upload,
    so callers that need one variant should not pay for three."""
    e = symmetrize(edge_index, n_node)
    deg = np.bincount(e[0], minlength=n_node).astype(np.float64)
    dis = np.where(deg > 0, deg**-0.5, 0.0)
    dad = (dis[e[0]] * dis[e[1]]).astype(np.float32)
    da = (dis[e[0]] * dis[e[0]]).astype(np.float32)
    ad = (dis[e[1]] * dis[e[1]]).astype(np.float32)
    mk = partial(_adj_graph, e, n_node)
    ws = {"DAD": dad, "DA": da, "AD": ad}
    return tuple(
        mk(w=ws[name]) if which is None or name in which else None
        for name in ("DAD", "DA", "AD")
    )


def gen_normalized_dist_adj(edge_index: np.ndarray, n_node: int, mesh,
                            which: str = "DAD", *, axis: str = "graph",
                            model_axis=None, rb: int = 128):
    """One normalized adjacency as a row-sharded DistGraph — the sharded
    counterpart of gen_normalized_adjs for label propagation / C&S on a
    mesh (the reference forces these to CPU, LP_Adj.py:149-152; here they
    ride the same ring SpMM as the teacher). Same weight math and the same
    flipped-edge convention as _adj_graph."""
    from ..parallel.distgraph import build_dist_graph

    e = symmetrize(edge_index, n_node)
    deg = np.bincount(e[0], minlength=n_node).astype(np.float64)
    dis = np.where(deg > 0, deg**-0.5, 0.0)
    ws = {
        "DAD": (dis[e[0]] * dis[e[1]]).astype(np.float32),
        "DA": (dis[e[0]] * dis[e[0]]).astype(np.float32),
        "AD": (dis[e[1]] * dis[e[1]]).astype(np.float32),
    }
    flipped = np.stack([e[1], e[0]])
    return build_dist_graph(flipped, n_node, mesh, edge_weight=ws[which],
                            axis=axis, model_axis=model_axis, rb=rb)


def general_outcome_correlation(
    adj: Graph,
    y: jax.Array,
    alpha: float,
    num_propagations: int,
    post_step: Callable[[jax.Array], jax.Array],
    alpha_term: bool = True,
    spmm_method: str = "gather",
) -> jax.Array:
    """outcome_correlation.py:128-145 as a jitted fori_loop."""

    def body(_, result):
        result = alpha * spmm(adj, result, spmm_method)
        result = result + ((1 - alpha) * y if alpha_term else y)
        return post_step(result)

    return jax.lax.fori_loop(0, num_propagations, body, y)


def _idx_mask(idx: jax.Array, n: int) -> jax.Array:
    """[n, 1] float 0/1 mask from an index vector. The scatter runs on a
    replicated zeros vector, so every function below stays a pure
    elementwise expression over the (possibly row-sharded) label/output
    matrices — no gather/scatter against sharded operands, which GSPMD
    refuses to reshard implicitly. On one device this is the same math in
    the same precision as the reference's index_put forms."""
    return jnp.zeros((n, 1), jnp.float32).at[idx].set(1.0)


def one_hot_labels(y: jax.Array, label_idx: jax.Array, num_classes: int,
                   n_node: int) -> jax.Array:
    """Zero matrix with one-hot labels at label_idx
    (outcome_correlation.py:147-153)."""
    return _idx_mask(label_idx, n_node) * jax.nn.one_hot(y, num_classes)


def label_propagation(
    y: jax.Array,
    label_idx: jax.Array,
    adj: Graph,
    alpha: float,
    num_propagations: int,
    num_classes: int,
    spmm_method: str = "gather",
) -> jax.Array:
    """Pure LP (outcome_correlation.py:147-156): propagate one-hot train
    labels, clamp [0, 1]. ``adj`` may be a DistGraph (rows then run at its
    padded count; padding rows have no edges and stay 0)."""
    n_rows = getattr(adj, "n_node_pad", 0) or adj.n_node
    y0 = one_hot_labels(y, label_idx, num_classes, n_rows)
    return general_outcome_correlation(
        adj, y0, alpha, num_propagations,
        post_step=lambda x: jnp.clip(x, 0.0, 1.0),
        alpha_term=True, spmm_method=spmm_method,
    )


def pre_residual_correlation(y, model_out, label_idx, num_classes):
    """(labels - model_out) at labeled rows, 0 elsewhere
    (outcome_correlation.py:95-110)."""
    m = _idx_mask(label_idx, model_out.shape[0])
    return m * (jax.nn.one_hot(y, num_classes) - model_out)


def pre_outcome_correlation(y, model_out, label_idx, num_classes):
    """model_out with labels snapped in at labeled rows
    (outcome_correlation.py:112-126)."""
    m = _idx_mask(label_idx, model_out.shape[0])
    return jnp.where(m > 0, jax.nn.one_hot(y, num_classes), model_out)


def double_correlation_autoscale(
    y, model_out, label_idx, residual_idx,
    A1: Graph, alpha1: float, num_prop1: int,
    A2: Graph, alpha2: float, num_prop2: int,
    num_classes: int, spmm_method: str = "gather",
):
    """Correct (autoscaled residual) & Smooth (outcome_correlation.py:158-180)."""
    y0 = pre_residual_correlation(y, model_out, residual_idx, num_classes)
    resid = general_outcome_correlation(
        A1, y0, alpha1, num_prop1,
        post_step=lambda x: jnp.clip(x, -1.0, 1.0),
        spmm_method=spmm_method,
    )
    m_r = _idx_mask(residual_idx, y0.shape[0])
    orig_diff = jnp.sum(m_r * jnp.abs(y0)) / residual_idx.shape[0]
    scale = orig_diff / jnp.sum(jnp.abs(resid), axis=1, keepdims=True)
    scale = jnp.where(jnp.isinf(scale), 1.0, scale)
    scale = jnp.where(scale > 1000.0, 1.0, scale)
    res_result = model_out + scale * resid
    res_result = jnp.where(jnp.isnan(res_result), model_out, res_result)
    y1 = pre_outcome_correlation(y, res_result, label_idx, num_classes)
    result = general_outcome_correlation(
        A2, y1, alpha2, num_prop2,
        post_step=lambda x: jnp.clip(x, 0.0, 1.0),
        spmm_method=spmm_method,
    )
    return res_result, result


def double_correlation_fixed(
    y, model_out, label_idx, residual_idx,
    A1: Graph, alpha1: float, num_prop1: int,
    A2: Graph, alpha2: float, num_prop2: int,
    num_classes: int, scale: float = 1.0, spmm_method: str = "gather",
):
    """Correct (residual re-pinned each step) & Smooth
    (outcome_correlation.py:182-206)."""
    y0 = pre_residual_correlation(y, model_out, residual_idx, num_classes)
    m_r = _idx_mask(residual_idx, y0.shape[0])

    def fix_inputs(x):
        # re-pin the residual rows each step (y0 holds them already)
        return jnp.where(m_r > 0, y0, x)

    resid = general_outcome_correlation(
        A1, y0, alpha1, num_prop1, post_step=fix_inputs,
        spmm_method=spmm_method,
    )
    res_result = model_out + scale * resid
    y1 = pre_outcome_correlation(y, res_result, label_idx, num_classes)
    result = general_outcome_correlation(
        A2, y1, alpha2, num_prop2,
        post_step=lambda x: jnp.clip(x, 0.0, 1.0),
        spmm_method=spmm_method,
    )
    return res_result, result


def only_outcome_correlation(
    y, model_out, label_idx, A: Graph, alpha: float, num_prop: int,
    num_classes: int, spmm_method: str = "gather",
):
    """outcome_correlation.py:208-213."""
    y0 = pre_outcome_correlation(y, model_out, label_idx, num_classes)
    result = general_outcome_correlation(
        A, y0, alpha, num_prop,
        post_step=lambda x: jnp.clip(x, 0.0, 1.0),
        spmm_method=spmm_method,
    )
    return model_out, result
