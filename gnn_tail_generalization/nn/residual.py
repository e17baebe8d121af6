"""Residual / initial / dense / jumping connection tricks.

Reference parity: ``/root/reference/GNN_model/res_tricks.py``
- ResidualConnection (7-14):  (1-a) X_l + a X_{l-1}
- InitialConnection (16-23):  (1-a) X_l + a X_0
- DenseConnection   (25-55):  concat+Linear | maxpool | sigmoid-attention
  over the whole collected layer list (also used for Jumping aggregation,
  GCN.py:73-79).
"""
from __future__ import annotations

from typing import List

from . import module as nn
import jax.numpy as jnp


def residual_connection(xs: List, alpha: float):
    if len(xs) == 1:
        return xs[-1]
    return (1 - alpha) * xs[-1] + alpha * xs[-2]


def initial_connection(xs: List, alpha: float):
    if len(xs) == 1:
        return xs[-1]
    return (1 - alpha) * xs[-1] + alpha * xs[0]


class DenseConnection(nn.Module):
    """res_tricks.py:25-55."""

    out_dim: int
    aggregation: str = "concat"  # concat | maxpool | attention

    @nn.compact
    def __call__(self, xs: List):
        if self.aggregation == "concat":
            x = jnp.concatenate(xs, axis=-1)
            return nn.Dense(self.out_dim, use_bias=True)(x)
        if self.aggregation == "maxpool":
            return jnp.max(jnp.stack(xs, axis=-1), axis=-1)
        if self.aggregation == "attention":
            # pps: [N, L, C]; retain: sigmoid(Linear(pps)) -> [N, 1, L]
            pps = jnp.stack(xs, axis=1)
            retain = nn.Dense(1, use_bias=True)(pps)[..., 0]  # [N, L]
            retain = nn.sigmoid(retain)[:, None, :]  # [N, 1, L]
            return jnp.matmul(retain, pps)[:, 0, :]  # [N, C]
        raise ValueError(self.aggregation)
