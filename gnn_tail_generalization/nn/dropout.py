"""Fast dropout: threshold random halfwords instead of full uniforms.

``jax.random.bernoulli`` draws one uint32 per element and converts it to a
float uniform before comparing — at full-graph scale ([N, 128] + [N, 256]
masks at ogbn-arxiv's N) that is a sizeable share of a train step. This
dropout draws ONE uint32 per TWO elements and thresholds the 16-bit
halves directly:

- keep decision: ``half < round(keep * 65536)`` — an exact
  Bernoulli(t/65536) with t the rounded threshold, so the keep probability
  is quantized to 1/65536 (worst-case 7.6e-6 off the requested rate).
- scaling uses the EXACT realized keep probability t/65536, so the mask
  stays unbiased: E[out] == x regardless of the quantization.
- the two halves mask two CONTIGUOUS column blocks (element (r, c) of
  block k uses half k of ``bits[r, c]``), avoiding an interleaving
  relayout; halves of one draw are independent.

Deviation note (PARITY.md): the reference's dropout is torch's — RNG
streams never match across frameworks anyway; per-element marginals here
are Bernoulli(keep) up to 1/65536 quantization.
"""
from __future__ import annotations

import numpy as np

from . import module as nn
import jax
import jax.numpy as jnp


def fast_dropout_mask(rng, keep: float, shape) -> jax.Array:
    """Boolean keep-mask of ``shape`` (2-D, even columns) from halfword
    thresholds, and the realized keep probability."""
    n, d = shape
    assert d % 2 == 0, d
    bits = jax.random.bits(rng, (n, d // 2), jnp.uint32)
    t = np.uint32(max(1, min(65535, round(keep * 65536.0))))
    lo = (bits & np.uint32(0xFFFF)) < t
    hi = (bits >> np.uint32(16)) < t
    return jnp.concatenate([lo, hi], axis=1), float(t) / 65536.0


class FastDropout(nn.Module):
    """Drop-in for nn.Dropout on 2-D activations in the hot path."""

    rate: float
    rng_collection: str = "dropout"

    @nn.compact
    def __call__(self, x, *, deterministic: bool):
        if deterministic or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return jnp.zeros_like(x)
        if x.ndim != 2 or x.shape[-1] % 2 != 0:
            return nn.Dropout(self.rate, deterministic=False,
                              rng_collection=self.rng_collection)(x)
        rng = self.make_rng(self.rng_collection)
        mask, keep = fast_dropout_mask(rng, 1.0 - self.rate, x.shape)
        return jnp.where(mask, x / keep, jnp.zeros_like(x))
