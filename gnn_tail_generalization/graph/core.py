"""Static-shape graph container and host-side graph builders.

Design notes
------------
XLA compiles one program per shape, so the graph is stored with *padded,
static* shapes: the edge list is padded to a multiple of ``pad_multiple`` and
padding edges carry ``edge_weight == 0`` (they point at the last node so the
edge list stays sorted by destination). All hot ops treat edge weight 0 as
"no edge", which makes padding, DropEdge-style edge masking and isolation
crafting the *same* mechanism.

Edges are kept twice, sorted by destination (for the forward SpMM
``y[dst] += w * x[src]``) and sorted by source (the transposed view used by
the SpMM backward pass). Both orders are built once on the host.

Reference parity (semantics, not code):
- edge utilities: ``/root/reference/utils.py:1119-1326`` (graphUtils)
- symmetrize:     ``/root/reference/utils.py:667-674``  (A + A^T, coalesced)
- loader pipeline symmetrize -> remove self loops -> add self loops:
  ``/root/reference/trainer_node_classification.py:655-662``
- degree semantics of the conv normalization (in/out degree of the directed
  edge list, *including* self loops, clamped to >= 1):
  ``/root/reference/GNN_model/GCN.py:205-213,242-250``
- GCN normalization D^-1/2 (A+I) D^-1/2: ``/root/reference/utils.py:1225-1241``
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "senders",
        "receivers",
        "edge_weight",
        "senders_t",
        "receivers_t",
        "edge_weight_t",
        "t_from_fwd",
        "deg_out",
        "deg_in",
    ],
    meta_fields=["n_node", "n_edge"],
)
@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable device-resident graph.

    ``senders/receivers/edge_weight`` are sorted by ``receivers`` (dst-major).
    ``*_t`` holds the reversed edges (senders_t = original receivers' role
    swap) sorted by ``receivers_t``, i.e. the ready-to-run forward edge list
    of A^T. ``n_edge`` is the true (unpadded) edge count; arrays have length
    ``E_pad >= n_edge``.
    """

    senders: jax.Array
    receivers: jax.Array
    edge_weight: jax.Array
    senders_t: jax.Array
    receivers_t: jax.Array
    edge_weight_t: jax.Array
    t_from_fwd: jax.Array  # [E_pad] int32: edge_weight_t == edge_weight[t_from_fwd]
    deg_out: jax.Array  # [N] float32, includes self loops and duplicates
    deg_in: jax.Array  # [N] float32
    n_node: int = 0
    n_edge: int = 0

    @property
    def e_pad(self) -> int:
        return self.senders.shape[0]

    def transpose(self) -> "Graph":
        """The reversed-edge graph (dst-sorted view is the *_t arrays)."""
        inv = jnp.argsort(self.t_from_fwd)
        return Graph(
            senders=self.senders_t,
            receivers=self.receivers_t,
            edge_weight=self.edge_weight_t,
            senders_t=self.senders,
            receivers_t=self.receivers,
            edge_weight_t=self.edge_weight,
            t_from_fwd=inv,
            deg_out=self.deg_in,
            deg_in=self.deg_out,
            n_node=self.n_node,
            n_edge=self.n_edge,
        )

    def with_edge_weight(
        self, w: jax.Array, w_t: Optional[jax.Array] = None,
    ) -> "Graph":
        """Replace edge weights (dst-sorted order). ``w_t`` defaults to the
        consistent permutation of ``w``.

        Padding slots are force-masked to 0: the static-shape padding edges
        are (last_node -> last_node) self-loops, and caller-provided
        weights (learned edge weights, sigmoid outputs, ...) would
        otherwise aggregate real values through them."""
        real = jnp.arange(self.e_pad) < self.n_edge
        w = jnp.where(real, w, 0.0)
        if w_t is None:
            w_t = w[self.t_from_fwd]
        else:
            w_t = jnp.where(real, w_t, 0.0)
        return dataclasses.replace(self, edge_weight=w, edge_weight_t=w_t)


# ---------------------------------------------------------------------------
# Host-side edge-index transforms (numpy; run once at data-load time)
# ---------------------------------------------------------------------------


def _as_np(edge_index) -> np.ndarray:
    e = np.asarray(edge_index)
    assert e.ndim == 2 and e.shape[0] == 2, f"edge_index shape {e.shape}"
    return e.astype(np.int64)


def coalesce(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    """Deduplicate edges, returning them sorted by (dst, src) (row-major on
    dst to match the coalesced COO order of utils.py:667-674)."""
    e = _as_np(edge_index)
    keys = e[1] * n_node + e[0]
    keys = np.unique(keys)
    return np.stack([keys % n_node, keys // n_node])


def symmetrize(edge_index: np.ndarray, n_node: Optional[int] = None) -> np.ndarray:
    """A <- A + A^T with deduplication (utils.py:667-674 semantics)."""
    e = _as_np(edge_index)
    if n_node is None:
        n_node = int(e.max()) + 1
    both = np.concatenate([e, e[::-1]], axis=1)
    return coalesce(both, n_node)


def remove_self_loops(edge_index: np.ndarray) -> np.ndarray:
    e = _as_np(edge_index)
    return e[:, e[0] != e[1]]


def add_self_loops(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    e = _as_np(edge_index)
    loops = np.arange(n_node, dtype=np.int64)
    return np.concatenate([e, np.stack([loops, loops])], axis=1)


def standard_pipeline(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    """symmetrize -> remove self loops -> add self loops, the node-classification
    loader pipeline of trainer_node_classification.py:655-662."""
    e = symmetrize(edge_index, n_node)
    e = remove_self_loops(e)
    return add_self_loops(e, n_node)


def degrees(edge_index: np.ndarray, n_node: int):
    """(out_degree, in_degree) of the directed edge list, including self loops
    and duplicates — matches dgl out_degrees/in_degrees used at
    GNN_model/GCN.py:206,243 and graph_analyze at utils.py:300-334."""
    e = _as_np(edge_index)
    deg_out = np.bincount(e[0], minlength=n_node).astype(np.float32)
    deg_in = np.bincount(e[1], minlength=n_node).astype(np.float32)
    return deg_out, deg_in


def gcn_norm_weights(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    """Edge weights of D^-1/2 (A) D^-1/2 over the *given* edges, where D is the
    (in+out symmetric assumed) degree computed from the given edge list.

    For the normalized adjacency of utils.py:1225-1241 pass an edge list that
    already went through remove_self_loops+add_self_loops.
    """
    e = _as_np(edge_index)
    deg = np.bincount(e[1], minlength=n_node).astype(np.float64)
    dinv = np.where(deg > 0, deg ** -0.5, 0.0)
    return (dinv[e[0]] * dinv[e[1]]).astype(np.float32)


def build_graph(
    edge_index: np.ndarray,
    n_node: int,
    edge_weight: Optional[np.ndarray] = None,
    *,
    pad_multiple: int = 128,
    pad_to: Optional[int] = None,
) -> Graph:
    """Build the device Graph from a host edge list.

    ``edge_weight=None`` means unit weights (plain adjacency; the GCN degree
    normalization is applied *outside* the SpMM, see nn/gcn.py).
    """
    e = _as_np(edge_index)
    n_edge = e.shape[1]
    if edge_weight is None:
        w = np.ones(n_edge, dtype=np.float32)
    else:
        w = np.asarray(edge_weight, dtype=np.float32)
        assert w.shape == (n_edge,)

    deg_out, deg_in = degrees(e, n_node)

    e_pad = pad_to if pad_to is not None else max(round_up(max(n_edge, 1), pad_multiple), pad_multiple)
    assert e_pad >= n_edge

    def sorted_padded(src, dst, w, order):
        src, dst, w = src[order], dst[order], w[order]
        pad = e_pad - n_edge
        # Padding edges: (last_node -> last_node) with weight 0; keeps the
        # dst-sorted order and contributes nothing to weighted aggregation.
        src = np.concatenate([src, np.full(pad, n_node - 1, np.int64)])
        dst = np.concatenate([dst, np.full(pad, n_node - 1, np.int64)])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
        return (
            jnp.asarray(src, jnp.int32),
            jnp.asarray(dst, jnp.int32),
            jnp.asarray(w, jnp.float32),
        )

    order_f = np.argsort(e[1], kind="stable")
    order_t = np.argsort(e[0], kind="stable")
    senders, receivers, ew = sorted_padded(e[0], e[1], w, order_f)
    # transposed view: reversed edges sorted by their destination
    # (= original senders)
    senders_t, receivers_t, ew_t = sorted_padded(e[1], e[0], w, order_t)
    # permutation: edge_weight_t == edge_weight[t_from_fwd]
    inv_order_f = np.empty(n_edge, dtype=np.int64)
    inv_order_f[order_f] = np.arange(n_edge)
    t_from_fwd = np.concatenate(
        [inv_order_f[order_t], np.arange(n_edge, e_pad, dtype=np.int64)]
    )

    return Graph(
        senders=senders,
        receivers=receivers,
        edge_weight=ew,
        senders_t=senders_t,
        receivers_t=receivers_t,
        edge_weight_t=ew_t,
        t_from_fwd=jnp.asarray(t_from_fwd, jnp.int32),
        deg_out=jnp.asarray(deg_out),
        deg_in=jnp.asarray(deg_in),
        n_node=n_node,
        n_edge=n_edge,
    )


def loss_masked_view(
    g: Graph,
    edge_index: np.ndarray,
    dst_mask: np.ndarray,
    edge_weight: Optional[np.ndarray] = None,
) -> Graph:
    """A final-layer training view of ``g``: only edges whose destination is
    inside ``dst_mask`` are kept, but the degree arrays (i.e. the GCN
    normalization, GCN.py:205-250) stay those of the FULL graph.

    Rationale: when only loss-masked rows of the last conv's output feed
    the loss (NLL over the train mask), aggregating the other rows is dead
    compute — the gradient of the step is mathematically identical with
    them dropped, so the final layer's fwd+bwd SpMMs shrink proportionally
    to the mask. Rows outside the mask aggregate to
    zero — the returned view must ONLY be used when nothing row-coupling
    (cross-row norms, edgewise losses, collect_SE) consumes them.

    ``edge_index``/``edge_weight`` are the HOST arrays ``g`` was built from.
    """
    e = _as_np(edge_index)
    m = np.asarray(dst_mask, bool)
    keep = m[e[1]]
    e_sub = e[:, keep]
    w_sub = None if edge_weight is None else np.asarray(edge_weight)[keep]
    sub = build_graph(e_sub, g.n_node, w_sub)
    return dataclasses.replace(sub, deg_out=g.deg_out, deg_in=g.deg_in)


def subgraph_edges(
    edge_index: np.ndarray,
    subset: np.ndarray,
    n_node: int,
    relabel: bool = True,
    edge_attr: Optional[np.ndarray] = None,
):
    """Crop edges to a node subset, optionally relabeling (utils.py:1250-1267)."""
    e = _as_np(edge_index)
    mask = np.zeros(n_node, dtype=bool)
    mask[np.asarray(subset)] = True
    emask = mask[e[0]] & mask[e[1]]
    e = e[:, emask]
    attr = None if edge_attr is None else np.asarray(edge_attr)[emask]
    if relabel:
        new_id = np.zeros(n_node, dtype=np.int64)
        new_id[np.asarray(subset)] = np.arange(len(np.asarray(subset)))
        e = new_id[e]
    return e, attr
