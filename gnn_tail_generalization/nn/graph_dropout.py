"""Graph-dropout tricks as static-shape edge-weight masks.

Reference parity: ``/root/reference/GNN_model/drop_tricks.py``
- DropEdge (13-24): uniform Bernoulli edge drop
- DropNode (26-45): Bernoulli node subset, keep edges inside subset
- FastGCN  (47-69): importance-sample nodes, q(u) ∝ sum_{e into u} w_e^2,
  without replacement (via Gumbel top-k, which is exactly multinomial
  sampling without replacement)
- LADIES   (71-111): layer-dependent importance sampling, chained row masks
- DropoutTrick facade (127-172): per-layer (edge set) list

Instead of producing new (dynamic-shape) edge lists, every trick
produces an [E_pad] multiplier over the fixed edge list — 1.0 keeps the edge,
0.0 drops it. Static shapes, jit-stable, and composes with padding (pad
edges already carry weight 0).

NOTE (SURVEY.md §2.3): the reference computes these subgraphs but the conv
ignores them (GCN.py:92-115). The backbone only applies these masks when
``apply_graph_dropout=True``; the default reproduces the reference.
"""
from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp

from ..graph.core import Graph


def _real_edge_mask(g: Graph) -> jax.Array:
    return (g.edge_weight != 0).astype(jnp.float32)


def drop_edge(rng, g: Graph, drop_rate: float) -> jax.Array:
    keep = jax.random.bernoulli(rng, 1.0 - drop_rate, (g.e_pad,))
    return keep.astype(jnp.float32)


def drop_node(rng, g: Graph, drop_rate: float) -> jax.Array:
    keep_node = jax.random.bernoulli(rng, 1.0 - drop_rate, (g.n_node,))
    return (keep_node[g.senders] & keep_node[g.receivers]).astype(jnp.float32)


def _keep_topk_nodes(rng, weights: jax.Array, k: int) -> jax.Array:
    """Sample k nodes w/o replacement ∝ weights via Gumbel top-k; returns a
    bool node mask. Zero-weight nodes are never selected (match
    torch.multinomial semantics)."""
    logw = jnp.where(weights > 0, jnp.log(weights), -jnp.inf)
    gumbel = jax.random.gumbel(rng, weights.shape)
    scores = logw + gumbel
    _, idx = jax.lax.top_k(scores, k)
    mask = jnp.zeros(weights.shape[0], dtype=bool).at[idx].set(True)
    # guard: if fewer than k nodes have weight, top_k still returns k indices
    # with -inf scores; exclude them.
    return mask & (weights > 0)


def fastgcn(rng, g: Graph, drop_rate: float) -> jax.Array:
    """drop_tricks.py:55-69: q(u) ∝ sum of squared weights of edges INTO u."""
    w2 = g.edge_weight**2
    q = jax.ops.segment_sum(w2, g.receivers, num_segments=g.n_node,
                            indices_are_sorted=True)
    k = int(g.n_node * (1.0 - drop_rate))
    keep_node = _keep_topk_nodes(rng, q, k)
    return (keep_node[g.senders] & keep_node[g.receivers]).astype(jnp.float32)


def ladies(rng, g: Graph, drop_rate: float, num_layers: int) -> List[jax.Array]:
    """drop_tricks.py:80-111: per-layer masks, importance re-weighted by the
    previous layer's sampled rows; returned in layer order (reversed from
    sampling order, matching the reference's .reverse())."""
    k = int(g.n_node * (1.0 - drop_rate))
    masks = []
    row_mask = jnp.ones(g.e_pad, dtype=bool)
    rngs = jax.random.split(rng, num_layers)
    for i in range(num_layers):
        w = jnp.where(row_mask, g.edge_weight, 0.0)
        q = jax.ops.segment_sum(w**2, g.receivers, num_segments=g.n_node,
                                indices_are_sorted=True)
        keep_node = _keep_topk_nodes(rngs[i], q, k)
        row_mask = keep_node[g.senders]
        masks.append(
            (keep_node[g.senders] & keep_node[g.receivers]).astype(jnp.float32)
        )
    masks.reverse()
    return masks


def per_layer_edge_masks(
    rng,
    g: Graph,
    type_trick: str,
    drop_rate: float,
    num_layers: int,
    layerwise: bool,
    train: bool,
) -> Optional[List[jax.Array]]:
    """DropoutTrick facade (drop_tricks.py:127-172). Returns None when no
    drop trick is configured or not training (eval keeps the full graph,
    matching each trick's ``if not self.training`` early-out)."""
    if not train:
        return None
    if "DropEdge" in type_trick:
        fn = lambda r: drop_edge(r, g, drop_rate)
    elif "DropNode" in type_trick:
        fn = lambda r: drop_node(r, g, drop_rate)
    elif "FastGCN" in type_trick:
        fn = lambda r: fastgcn(r, g, drop_rate)
    elif "LADIES" in type_trick:
        assert layerwise, "LADIES requires layer-wise dropout flag on"
        return ladies(rng, g, drop_rate, num_layers)
    else:
        return None
    if layerwise:
        rngs = jax.random.split(rng, num_layers)
        return [fn(r) for r in rngs]
    m = fn(rng)
    return [m] * num_layers


def mask_view(g):
    """The edge list the mask samplers should draw over: the Graph itself
    single-device, or the canonical global-edge view of a sharded
    DistGraph (parallel/distgraph.global_edge_view)."""
    if isinstance(g, Graph):
        return g
    from ..parallel.distgraph import global_edge_view

    return global_edge_view(g)


def apply_edge_mask(g, mask: jax.Array):
    """Masked copy of ``g`` (single-device Graph or sharded DistGraph;
    the DistGraph re-scales its bucket weights via per-slot gid maps)."""
    if isinstance(g, Graph):
        return masked_graph(g, mask, g.t_from_fwd)
    from ..parallel.distgraph import masked_dist_graph

    return masked_dist_graph(g, mask)


def masked_graph(g: Graph, mask: jax.Array, t_from_fwd: jax.Array) -> Graph:
    """Apply an edge mask, recomputing degrees from the surviving edges
    (stop-gradient; degrees are structural)."""
    w = g.edge_weight * mask
    w_t = g.edge_weight_t * mask[t_from_fwd]
    deg_in = jax.ops.segment_sum(
        jnp.abs(jnp.sign(w)), g.receivers, num_segments=g.n_node,
        indices_are_sorted=True,
    )
    deg_out = jax.ops.segment_sum(
        jnp.abs(jnp.sign(w_t)), g.receivers_t, num_segments=g.n_node,
        indices_are_sorted=True,
    )
    import dataclasses

    return dataclasses.replace(
        g,
        edge_weight=jax.lax.stop_gradient(w),
        edge_weight_t=jax.lax.stop_gradient(w_t),
        deg_in=jax.lax.stop_gradient(deg_in),
        deg_out=jax.lax.stop_gradient(deg_out),
    )
