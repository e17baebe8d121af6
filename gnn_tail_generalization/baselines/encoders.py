"""Shared encoders for the self-supervised baselines: GIN and SAGE stacks.

Reference parity: the DGL GIN encoder used by DGI/EGI
(``/root/reference/Link_prediction_baseline/models/dgi.py`` GIN/MLP
classes) and the 2-layer mean-SAGE used by VGAE
(``/root/reference/Link_prediction_baseline/models/vgae.py:37-80``).
"""
from __future__ import annotations

from ..nn import module as nn
import jax.numpy as jnp

from ..graph.core import Graph
from ..ops.spmm import spmm


class GINLayer(nn.Module):
    """h' = MLP((1 + eps) h + sum_{j in N(i)} h_j), learnable eps."""

    out_dim: int
    hidden_dim: int | None = None

    @nn.compact
    def __call__(self, g: Graph, h, *, train: bool = False):
        eps = self.param("eps", nn.initializers.zeros, ())
        agg = spmm(g, h)
        z = (1.0 + eps) * h + agg
        hid = self.hidden_dim or self.out_dim
        z = nn.relu(nn.Dense(hid)(z))
        z = nn.Dense(self.out_dim)(z)
        z = nn.BatchNorm(use_running_average=not train)(z)
        return nn.relu(z)


class GINEncoder(nn.Module):
    hidden_dim: int
    num_layers: int = 2

    @nn.compact
    def __call__(self, g: Graph, x, *, train: bool = False):
        h = x
        for _ in range(self.num_layers):
            h = GINLayer(self.hidden_dim)(g, h, train=train)
        return h


class MeanSAGELayer(nn.Module):
    out_dim: int
    activation: bool = True

    @nn.compact
    def __call__(self, g: Graph, h):
        deg = jnp.clip(g.deg_in, 1.0, None)
        agg = spmm(g, h) / deg[:, None]
        z = nn.Dense(self.out_dim)(jnp.concatenate([h, agg], axis=-1))
        return nn.relu(z) if self.activation else z


class GCNSAGELayer(nn.Module):
    """dgl SAGEConv(aggregator_type='gcn'): W((sum_neighbors + h_self) /
    (deg + 1)) — no self-concat, one weight (the reference VGAE's tower,
    vgae.py:45-47)."""

    out_dim: int
    activation: bool = True

    @nn.compact
    def __call__(self, g: Graph, h):
        deg = g.deg_in
        agg = (spmm(g, h) + h) / (deg + 1.0)[:, None]
        z = nn.Dense(self.out_dim)(agg)
        return nn.relu(z) if self.activation else z
