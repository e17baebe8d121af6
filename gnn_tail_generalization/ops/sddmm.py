"""SDDMM-style edge scoring: per-edge dot products of endpoint embeddings.

Used by the edgewise (link-prediction) auxiliary loss — DistMult scoring
``score_e = sum(h[src_e] * h[dst_e])`` (``/root/reference/utils.py:754-757``)
and by the link-prediction predictors (``Link_prediction_model/layer.py``).

This is a batched gather + row-wise reduction; for the moderate edge
batches the reference uses (hundreds to 64k edges) XLA's gather suffices.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def edge_dot(h_src: jax.Array, h_dst: jax.Array) -> jax.Array:
    """DistMult score per edge row (utils.py:754-757)."""
    return jnp.sum(h_src * h_dst, axis=-1)


def sddmm(x: jax.Array, senders: jax.Array, receivers: jax.Array) -> jax.Array:
    """score_e = x[senders_e] . x[receivers_e] for an edge list."""
    return edge_dot(x[senders], x[receivers])
