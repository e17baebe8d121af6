"""GIN pretraining variants: attribute/degree masking and context prediction.

Reference parity:
- masking_GIN (``/root/reference/Link_prediction_baseline/models/pretrain_masking_gin.py:197-240``):
  GIN encoder + degree classifier trained with NLL against the node-degree
  bucket labels (optionally restricted to a masked node subset).
- contextpred_GIN (``/root/reference/Link_prediction_baseline/models/pretrain_contextpred_gin.py:173-233``):
  substructure representation (GIN at the center) scored against the
  mean-pooled representation of the OVERLAP nodes of a per-center context
  graph; negatives are cycle-shifted context rows;
  loss = BCE(pos) + neg_samples * BCE(neg).

Context graphs here are TRUE materialized subgraphs (the reference's
``contextgraph_loader`` is referenced but never constructed anywhere in
the shipped code — the module is broken as-is; the semantics follow the
context-prediction pretraining recipe it implements): for center v the
context graph is the subgraph induced on nodes at BFS distance in
[l1, l2], and the overlap set is the part also inside the substruct
encoder's K-hop neighborhood (distance <= K). Static shapes: the whole center
batch becomes ONE block-diagonal padded union Graph (fixed M nodes /
center, weight-0 edge masking), so the context encoder runs as a single
batched GIN forward.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..nn import module as nn
import jax
import jax.numpy as jnp

from ..graph.core import Graph, build_graph
from .encoders import GINEncoder


def build_context_graphs(edge_index: np.ndarray, n_node: int,
                         centers: np.ndarray, l1: int, l2: int, k_sub: int,
                         max_nodes: int = 64,
                         rng: Optional[np.random.Generator] = None):
    """Host-side context-graph batch builder.

    Returns (union_graph, flat_idx [B*M], node_mask [B*M], overlap_mask
    [B*M]): union_graph is the block-diagonal disjoint union of the B
    per-center context subgraphs, each padded to M=max_nodes local slots;
    flat_idx maps local slots to global node ids (0 on padding)."""
    rng = rng or np.random.default_rng(0)
    e = np.asarray(edge_index, np.int64)
    order = np.argsort(e[0], kind="stable")
    src_sorted, dst_sorted = e[0][order], e[1][order]
    indptr = np.searchsorted(src_sorted, np.arange(n_node + 1))

    def neighbors(u):
        return dst_sorted[indptr[u]: indptr[u + 1]]

    b, m = len(centers), max_nodes
    flat_idx = np.zeros(b * m, np.int32)
    node_mask = np.zeros(b * m, np.float32)
    overlap_mask = np.zeros(b * m, np.float32)
    union_src, union_dst = [], []

    for bi, c in enumerate(np.asarray(centers)):
        dist = {int(c): 0}
        frontier = [int(c)]
        for d in range(1, l2 + 1):
            nxt = []
            for u in frontier:
                for v in neighbors(u):
                    v = int(v)
                    if v not in dist:
                        dist[v] = d
                        nxt.append(v)
            frontier = nxt
        ctx = [v for v, d in dist.items() if l1 <= d <= l2]
        if len(ctx) > m:
            ctx = list(rng.choice(ctx, size=m, replace=False))
        local = {v: i for i, v in enumerate(ctx)}
        for v in ctx:
            s = bi * m + local[v]
            flat_idx[s] = v
            node_mask[s] = 1.0
            if dist[v] <= k_sub:
                overlap_mask[s] = 1.0
        for v in ctx:
            for w in neighbors(v):
                w = int(w)
                if w in local:
                    union_src.append(bi * m + local[v])
                    union_dst.append(bi * m + local[w])

    if not union_src:  # degenerate graphs: keep shapes valid
        union_src, union_dst = [0], [0]
    ug = build_graph(
        np.stack([np.asarray(union_src, np.int64),
                  np.asarray(union_dst, np.int64)]),
        b * m,
    )
    return (ug, jnp.asarray(flat_idx), jnp.asarray(node_mask),
            jnp.asarray(overlap_mask))


class MaskingGIN(nn.Module):
    hidden_dim: int
    num_layers: int = 2
    num_degree_classes: int = 32

    def setup(self):
        self.encoder = GINEncoder(self.hidden_dim, self.num_layers)
        self.degree_classifier = nn.Dense(self.num_degree_classes)

    def embed(self, g: Graph, x, *, train: bool = False):
        return self.encoder(g, x, train=train)

    def __call__(self, g: Graph, x, degree_labels, mask=None, *,
                 train: bool = False):
        emb = self.encoder(g, x, train=train)
        logp = jax.nn.log_softmax(self.degree_classifier(emb), axis=1)
        picked = jnp.take_along_axis(logp, degree_labels[:, None], axis=1)[:, 0]
        if mask is not None:
            m = mask.astype(jnp.float32)
            return -jnp.sum(picked * m) / jnp.maximum(m.sum(), 1.0)
        return -jnp.mean(picked)


class ContextPredGIN(nn.Module):
    hidden_dim: int
    k_sub: int = 2  # substruct encoder depth (reference n_layers > l1)
    l1: int = 1  # context inner radius
    l2: int = 3  # context outer radius
    neg_samples: int = 2

    def setup(self):
        assert self.k_sub > self.l1 and self.l2 > self.l1
        self.substruct = GINEncoder(self.hidden_dim, self.k_sub)
        # context encoder depth = l2 - l1 (pretrain_contextpred_gin.py:182)
        self.context = GINEncoder(self.hidden_dim, self.l2 - self.l1)

    def embed(self, g: Graph, x, *, train: bool = False):
        return self.substruct(g, x, train=train)

    def __call__(self, g: Graph, x, ctx_graph: Graph, ctx_idx, node_mask,
                 overlap_mask, centers, *, train: bool = False):
        b = centers.shape[0]
        sub = self.substruct(g, x, train=train)[centers]  # [B, H]
        # batched context forward on the block-diagonal union graph
        ctx_x = x[ctx_idx] * node_mask[:, None]
        h = self.context(ctx_graph, ctx_x, train=train)  # [B*M, H]
        hm = (h * overlap_mask[:, None]).reshape(b, -1, h.shape[-1])
        cnt = jnp.maximum(
            overlap_mask.reshape(b, -1).sum(axis=1), 1.0)[:, None]
        ctx_rep = hm.sum(axis=1) / cnt  # segment mean over overlap nodes
        valid = (overlap_mask.reshape(b, -1).sum(axis=1) > 0).astype(
            jnp.float32)

        pos = jnp.sum(sub * ctx_rep, axis=1)
        nv = jnp.maximum(valid.sum(), 1.0)
        loss = jnp.sum(jax.nn.softplus(-pos) * valid) / nv  # BCE vs 1
        neg_total = 0.0
        for i in range(self.neg_samples):
            ctx_neg = jnp.roll(ctx_rep, i + 1, axis=0)  # cycle_index
            vneg = valid * jnp.roll(valid, i + 1)
            neg = jnp.sum(sub * ctx_neg, axis=1)
            neg_total = neg_total + jnp.sum(
                jax.nn.softplus(neg) * vneg) / jnp.maximum(vneg.sum(), 1.0)
        # loss_pos + neg_samples * loss_neg (train_model:230)
        return loss + self.neg_samples * neg_total / max(self.neg_samples, 1)


def train_pretrain_gin(g: Graph, x, variant: str = "masking",
                       hidden_dim: int = 64, epochs: int = 50,
                       lr: float = 1e-3, seed: int = 0, log_every: int = 0,
                       degree_labels=None, mask=None,
                       edge_index: Optional[np.ndarray] = None,
                       n_centers: int = 128, max_ctx_nodes: int = 64):
    """run loop; returns (embeddings, params)."""
    import optax

    if variant == "masking":
        model = MaskingGIN(hidden_dim)
        if degree_labels is None:
            degree_labels = jnp.minimum(
                g.deg_in.astype(jnp.int32), model.num_degree_classes - 1
            )
        args = (g, x, degree_labels, mask)
    elif variant == "contextpred":
        model = ContextPredGIN(hidden_dim)
        n = x.shape[0]
        if edge_index is None:
            edge_index = np.stack([np.asarray(g.senders)[: g.n_edge],
                                   np.asarray(g.receivers)[: g.n_edge]])
        nprng = np.random.default_rng(seed)
        centers = (np.arange(n) if n <= n_centers
                   else nprng.choice(n, size=n_centers, replace=False))
        cg, ctx_idx, nmask, omask = build_context_graphs(
            edge_index, n, centers, model.l1, model.l2, model.k_sub,
            max_nodes=max_ctx_nodes, rng=nprng,
        )
        args = (g, x, cg, ctx_idx, nmask, omask,
                jnp.asarray(centers, jnp.int32))
    else:
        raise ValueError(variant)

    k = jax.random.PRNGKey(seed)
    variables = jax.jit(
        lambda *a: model.init({"params": k}, *a, train=True)
    )(*args)
    params, bs = variables["params"], variables.get("batch_stats")
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, bs, opt_state, *args):
        def loss_fn(p):
            vs = {"params": p}
            if bs is not None:
                vs["batch_stats"] = bs
            out, nv = model.apply(
                vs, *args, train=True,
                mutable=["batch_stats"] if bs is not None else [],
            )
            return out, nv.get("batch_stats") if bs is not None else None

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, new_bs, opt_state, loss

    for ep in range(epochs):
        params, bs, opt_state, loss = step(params, bs, opt_state, *args)
        if log_every and ep % log_every == 0:
            print(f"{variant} ep {ep}: loss={float(loss):.4f}")

    vs = {"params": params}
    if bs is not None:
        vs["batch_stats"] = bs
    embs = jax.jit(
        lambda vs, g, x: model.apply(vs, g, x, train=False,
                                     method=model.embed)
    )(vs, g, x)
    return jax.lax.stop_gradient(embs), params
