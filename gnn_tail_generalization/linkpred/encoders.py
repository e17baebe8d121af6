"""Link-prediction encoders: MLP / SAGE / GCN / WSAGE / Transformer.

Reference parity: ``/root/reference/Link_prediction_model/layer.py:19-83``
(PyG conv stacks, relu+dropout between layers, no activation after last).

Conv semantics (matching the PyG layers the reference instantiates):
- SAGEConv:   h = W_l x + W_r mean_{j in N(i)} x_j         (mean aggr, root)
- GCNConv(normalize=False): h = W (A @ x) + b              (A as given;
  the trainer pre-normalizes adj via gcn_normalization,
  Link_prediction_model/utils.py:93-99)
- GraphConv (WSAGE): h = W_1 x + W_2 sum_{j in N(i)} x_j   (sum aggr)
- TransformerConv: single-head dot-product attention over in-edges

All aggregations ride the framework SpMM; the attention softmax uses sorted
segment max/sum (no scatter thanks to dst-sorted edges... XLA segment ops).
"""
from __future__ import annotations

from typing import Optional

from ..nn import module as nn
import jax
import jax.numpy as jnp

from ..graph.core import Graph
from ..nn.dropout import FastDropout
from ..ops.spmm import spmm


def _mean_agg(g: Graph, x, method: str = "gather"):
    s = spmm(g, x, method)
    deg = jnp.clip(g.deg_in, 1.0, None)
    return s / deg[:, None].astype(s.dtype)


def _dense_dtype(spmm_method: str):
    """bf16 dense matmuls when the aggregation already runs on bf16
    operands (it rounds activations to bf16 anyway; nn/gcn.py does the
    same)."""
    return jnp.bfloat16 if spmm_method == "bf16_operands" else None


class SAGEConv(nn.Module):
    out_channels: int
    spmm_method: str = "gather"

    @nn.compact
    def __call__(self, g: Graph, x, agg: Optional[jax.Array] = None):
        if agg is None:
            agg = _mean_agg(g, x, self.spmm_method)
        dt = _dense_dtype(self.spmm_method)
        return (nn.Dense(self.out_channels, dtype=dt)(x)
                + nn.Dense(self.out_channels, use_bias=False, dtype=dt)(agg)
                ).astype(jnp.float32)


class GCNConvRaw(nn.Module):
    """PyG GCNConv(normalize=False): aggregate with the (pre-normalized)
    adjacency weights baked into the graph.

    ``agg``: optional precomputed ``spmm(g, x)`` — note the hoisted
    aggregation here is over the RAW input (W is applied after), unlike
    the layer's usual aggregate-after-projection order; hoisting callers
    use :func:`hoisted_first_agg` which encodes this per conv kind."""

    out_channels: int
    spmm_method: str = "gather"

    @nn.compact
    def __call__(self, g: Graph, x, agg: Optional[jax.Array] = None):
        dt = _dense_dtype(self.spmm_method)
        if agg is None:
            h = nn.Dense(self.out_channels, use_bias=False, dtype=dt)(x)
            y = spmm(g, h, self.spmm_method)
        else:
            # A @ (x W) == (A @ x) W: reuse the constant aggregation
            y = nn.Dense(self.out_channels, use_bias=False, dtype=dt)(agg)
        b = self.param("bias", nn.initializers.zeros, (self.out_channels,))
        return (y + b).astype(jnp.float32)


class WSAGEConv(nn.Module):
    """PyG GraphConv: root Dense + sum-aggregated Dense."""

    out_channels: int
    spmm_method: str = "gather"

    @nn.compact
    def __call__(self, g: Graph, x, agg: Optional[jax.Array] = None):
        if agg is None:
            agg = spmm(g, x, self.spmm_method)
        dt = _dense_dtype(self.spmm_method)
        return (nn.Dense(self.out_channels, dtype=dt)(x)
                + nn.Dense(self.out_channels, use_bias=False, dtype=dt)(agg)
                ).astype(jnp.float32)


class TransformerConv(nn.Module):
    """Single-head TransformerConv (layer.py:77-83): per-edge attention
    alpha_e = softmax_{e into dst}(q[dst] . k[src] / sqrt(d))."""

    out_channels: int
    spmm_method: str = "gather"  # accepted for factory uniformity (unused)

    @nn.compact
    def __call__(self, g: Graph, x):
        d = self.out_channels
        q = nn.Dense(d)(x)
        k = nn.Dense(d)(x)
        v = nn.Dense(d)(x)
        logits = jnp.sum(
            q[g.receivers] * k[g.senders], axis=-1
        ) / jnp.sqrt(float(d))
        # mask padding edges
        logits = jnp.where(g.edge_weight != 0, logits, -jnp.inf)
        seg_max = jax.ops.segment_max(
            logits, g.receivers, num_segments=g.n_node,
            indices_are_sorted=True,
        )
        seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
        expd = jnp.where(
            g.edge_weight != 0,
            jnp.exp(logits - seg_max[g.receivers]), 0.0,
        )
        denom = jax.ops.segment_sum(
            expd, g.receivers, num_segments=g.n_node, indices_are_sorted=True
        )
        alpha = expd / jnp.maximum(denom[g.receivers], 1e-16)
        contrib = v[g.senders] * alpha[:, None]
        out = jax.ops.segment_sum(
            contrib, g.receivers, num_segments=g.n_node,
            indices_are_sorted=True,
        )
        # skip connection (PyG TransformerConv root_weight=True)
        return out + nn.Dense(d)(x)


_CONVS = {
    "SAGE": SAGEConv,
    "GCN": GCNConvRaw,
    "WSAGE": WSAGEConv,
    "Transformer": TransformerConv,
}


def hoistable(kind: str) -> bool:
    """Conv kinds whose FIRST layer aggregation is a pure function of the
    input features (no parameters before the SpMM) — SAGE/WSAGE aggregate
    raw x; GCN's ``A @ (x W) == (A @ x) W``. Transformer's attention
    weights depend on params; MLP has no aggregation."""
    return kind in ("SAGE", "WSAGE", "GCN")


def hoisted_first_agg(kind: str, g: Graph, x, spmm_method: str = "gather"):
    """The layer-1 aggregation as a constant, for encoders whose input
    features are static across training steps (use_node_feats without a
    trainable embedding). The reference re-aggregates the SAME input
    every minibatch (full-graph encode per batch, Link_prediction_model/
    model.py:144-152 + layer.py:29-35) — hoisting this loop invariant
    removes one of the three SpMMs from every train step with bitwise-
    identical aggregation output (same kernel, same operands)."""
    assert hoistable(kind)
    if kind == "SAGE":
        return _mean_agg(g, x, spmm_method)
    return spmm(g, x, spmm_method)  # WSAGE sum / GCN pre-normalized A @ x


class GNNEncoder(nn.Module):
    """BaseGNN stack (layer.py:19-35): conv -> relu -> dropout between
    layers, bare conv at the end. kind='MLP' uses Linears and ignores g.

    ``agg0``: optional precomputed layer-1 aggregation (hoisted_first_agg)
    — only valid when the input features are constant under training.
    Inter-layer dropout uses the halfword-threshold FastDropout (exact
    Bernoulli marginals up to 1/65536 quantization, nn/dropout.py): half
    the random bits of a bernoulli mask over [N, 256]."""

    kind: str
    hidden_channels: int
    out_channels: int
    num_layers: int
    dropout: float = 0.0
    spmm_method: str = "gather"  # see ops/spmm.SPMM_METHODS

    @nn.compact
    def __call__(self, g, x, *, train: bool = False,
                 agg0: Optional[jax.Array] = None):
        for i in range(self.num_layers):
            out = (self.out_channels if i == self.num_layers - 1
                   else self.hidden_channels)
            if self.kind == "MLP":
                x = nn.Dense(out)(x)
            else:
                conv = _CONVS[self.kind](out, spmm_method=self.spmm_method)
                if i == 0 and agg0 is not None:
                    assert hoistable(self.kind), self.kind
                    x = conv(g, x, agg0)
                else:
                    x = conv(g, x)
            if i < self.num_layers - 1:
                x = nn.relu(x)
                x = FastDropout(self.dropout)(x, deterministic=not train)
        return x
