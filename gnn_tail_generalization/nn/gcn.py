"""GCN convolution with Cold Brew Structural Embeddings (SE).

Math (GNN_model/GCN.py:228-229):
    X^{l+1} = sigma( A_tilde ( X^l W^l + E^l ) )
with A_tilde the degree-normalized adjacency applied in DGL's split form
(GCN.py:205-250): scale sources by out_deg^-1/2 BEFORE the dense matmul,
aggregate, scale destinations by in_deg^-1/2 AFTER — degrees clamped >= 1.
E^l in R^{N x d_out} is the learnable structural embedding, added AFTER the
weight matmul / source scaling (so E itself is NOT out-degree scaled), and
its Frobenius norm (not squared — th.norm, GCN.py:232) is returned for the
se_reg loss term.

The aggregation is the framework SpMM (ops/spmm.py) — one matmul on
dense-materialized small graphs, sorted gather/segment-sum on large ones.
"""
from __future__ import annotations

from . import module as nn
import jax
import jax.numpy as jnp

from ..graph.core import Graph
from ..ops.spmm import spmm


class GCNConv(nn.Module):
    out_feats: int
    n_node: int
    has_se: bool = False
    norm: str = "both"  # both | left | right | none
    use_bias: bool = True
    spmm_method: str = "gather"

    @nn.compact
    def __call__(self, g: Graph, x):
        h = x
        if self.norm in ("left", "both"):
            d = jnp.clip(g.deg_out, 1.0, None)
            scale = d**-0.5 if self.norm == "both" else 1.0 / d
            h = h * scale[:, None].astype(h.dtype)

        w = self.param(
            "kernel",
            nn.initializers.xavier_uniform(),  # torch init.xavier_uniform_
            (x.shape[-1], self.out_feats),
        )
        if self.spmm_method == "bf16_operands":
            # the aggregation already rounds h to bf16, so the dense
            # matmul takes bf16 operands with f32 accumulation too
            h = jnp.matmul(h.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
        else:
            h = jnp.matmul(h, w, precision=jax.lax.Precision.HIGHEST)

        se_reg = None
        if self.has_se:
            le = self.param(
                "se",  # torch.randn init (GCN.py:182)
                nn.initializers.normal(stddev=1.0),
                (self.n_node, self.out_feats),
            )
            h = h + le
            se_reg = jnp.linalg.norm(le.reshape(-1))  # Frobenius, not squared

        y = spmm(g, h, self.spmm_method)

        if self.norm in ("right", "both"):
            d = jnp.clip(g.deg_in, 1.0, None)
            scale = d**-0.5 if self.norm == "both" else 1.0 / d
            y = y * scale[:, None].astype(y.dtype)

        if self.use_bias:
            b = self.param("bias", nn.initializers.zeros, (self.out_feats,))
            y = y + b
        return y, se_reg
