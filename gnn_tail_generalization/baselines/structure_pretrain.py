"""Structural pretraining: link reconstruction + centrality ranking.

Reference parity: ``/root/reference/Link_prediction_baseline/models/structure_pretrain.py:152-332``
(Struct_Feat_Pretrain):
- encoder (GIN or GCN) returning per-layer embeddings, combined with a
  learnable softmax(psi) layer-mixture scaled by alpha — one mixture for
  each loss head (254-279)
- link head: Neural-Tensor-Network decoder (NeuralTensorLayer, 152-162 +
  NTN_Decoder, 227-240) over the masked graph's embeddings, BCE on
  positive/negative edge labels (304-305)
- centrality head: per-centrality MLP scalar scorers; pairwise ranking
  pred = s[u] - s[v], pos-weighted BCE against the comparison labels
  (313-324). Centralities here: in-degree and PageRank (host-precomputed).
"""
from __future__ import annotations

import numpy as np

from ..nn import module as nn
import jax
import jax.numpy as jnp

from ..graph.core import Graph
from .encoders import GINLayer


class NeuralTensorLayer(nn.Module):
    """score_k = u^T W_k v + V [u; v] + b (structure_pretrain.py:152-162)."""

    out_dim: int

    @nn.compact
    def __call__(self, u, v):
        d = u.shape[-1]
        w = self.param("w", nn.initializers.xavier_uniform(),
                       (self.out_dim, d, d))
        vv = self.param("v", nn.initializers.xavier_uniform(),
                        (2 * d, self.out_dim))
        b = self.param("b", nn.initializers.zeros, (self.out_dim,))
        bilinear = jnp.einsum("bd,kde,be->bk", u, w, v)
        linear = jnp.concatenate([u, v], axis=-1) @ vv
        return jnp.tanh(bilinear + linear + b)


class NTNDecoder(nn.Module):
    """NTN -> Dense(1) (structure_pretrain.py:227-240)."""

    tensor_dim: int = 16

    @nn.compact
    def __call__(self, u, v):
        h = NeuralTensorLayer(self.tensor_dim)(u, v)
        return nn.Dense(1)(h)[..., 0]


class StructFeatPretrain(nn.Module):
    hidden_dim: int
    num_layers: int = 2
    n_centralities: int = 2

    def setup(self):
        self.feature_mapping = nn.Dense(self.hidden_dim)
        self.layers = [GINLayer(self.hidden_dim)
                       for _ in range(self.num_layers)]
        self.link_psi = self.param(
            "link_psi", nn.initializers.uniform(1.0), (self.num_layers + 2,))
        self.link_alpha = self.param(
            "link_alpha", nn.initializers.ones, (1,))
        self.link_decoder = NTNDecoder()
        self.cent_psi = self.param(
            "cent_psi", nn.initializers.uniform(1.0), (self.num_layers + 2,))
        self.cent_alpha = self.param(
            "cent_alpha", nn.initializers.ones, (1,))
        self.cent_decoders = [nn.Dense(1)
                              for _ in range(self.n_centralities)]

    def per_layer(self, g: Graph, x, *, train: bool = False):
        h = jnp.tanh(self.feature_mapping(x))
        outs = [jnp.pad(x, ((0, 0), (0, self.hidden_dim - x.shape[1])))
                if x.shape[1] < self.hidden_dim else x[:, : self.hidden_dim],
                h]
        for layer in self.layers:
            h = layer(g, h, train=train)
            outs.append(h)
        return jnp.stack(outs)  # [L+2, N, D]

    def _mix(self, stack, psi, alpha):
        w = jax.nn.softmax(psi)[:, None, None]
        return (w * stack).sum(axis=0) * alpha[0]

    def embed(self, g: Graph, x, *, train: bool = False):
        return self._mix(self.per_layer(g, x, train=train), self.link_psi,
                         self.link_alpha)

    def __call__(self, g: Graph, masked_g: Graph, x, link_edges, link_labels,
                 cent_pairs, cent_labels, *, train: bool = False):
        """link_edges [B, 2] with 0/1 labels; cent_pairs [B2, 2] node pairs
        with per-centrality comparison labels [B2, C]."""
        stack_m = self.per_layer(masked_g, x, train=train)
        link_emb = self._mix(stack_m, self.link_psi, self.link_alpha)
        logits = self.link_decoder(link_emb[link_edges[:, 0]],
                                   link_emb[link_edges[:, 1]])
        l = link_labels.astype(jnp.float32)
        link_loss = jnp.mean(
            jnp.maximum(logits, 0) - logits * l
            + jnp.log1p(jnp.exp(-jnp.abs(logits)))
        )

        stack = self.per_layer(g, x, train=train)
        cent_emb = self._mix(stack, self.cent_psi, self.cent_alpha)
        cent_loss = 0.0
        for i, dec in enumerate(self.cent_decoders):
            score = dec(cent_emb)[..., 0]
            pred = score[cent_pairs[:, 0]] - score[cent_pairs[:, 1]]
            lab = cent_labels[:, i].astype(jnp.float32)
            pos = jnp.maximum(lab.sum(), 1.0)
            neg = jnp.maximum(lab.shape[0] - lab.sum(), 1.0)
            pos_weight = neg / pos
            norm = lab.shape[0] / neg
            w = jnp.where(lab > 0, pos_weight, 1.0)
            bce = jnp.mean(w * (jnp.maximum(pred, 0) - pred * lab
                                + jnp.log1p(jnp.exp(-jnp.abs(pred)))))
            cent_loss = cent_loss + norm * bce
        return link_loss + cent_loss


def compute_centralities(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    """[N, 2]: in-degree and PageRank (host-side)."""
    import scipy.sparse as ssp

    e = np.asarray(edge_index)
    deg = np.bincount(e[1], minlength=n_node).astype(np.float64)
    a = ssp.csr_matrix((np.ones(e.shape[1]), (e[0], e[1])),
                       shape=(n_node, n_node))
    from ..linkpred.heuristics import _pagerank_power

    pr = _pagerank_power(a, np.ones(n_node), p=0.85)
    return np.stack([deg, pr], axis=1)
