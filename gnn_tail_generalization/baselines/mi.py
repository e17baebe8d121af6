"""Mutual-information estimation measures (f-divergence expectations).

Reference parity: ``/root/reference/Link_prediction_baseline/models/utils.py:12-156``
(get_positive_expectation / get_negative_expectation, the Deep-InfoMax
measure zoo used by the EGI/SubGI loss, plus the MINE statistic network —
here a module of nn/module.py).
"""
from __future__ import annotations

import math

from ..nn import module as nn
import jax
import jax.numpy as jnp

_LOG2 = math.log(2.0)


def positive_expectation(p_samples, measure: str, average: bool = True):
    if measure == "GAN":
        ep = -jax.nn.softplus(-p_samples)
    elif measure == "JSD":
        ep = _LOG2 - jax.nn.softplus(-p_samples)
    elif measure == "X2":
        ep = p_samples**2
    elif measure == "KL":
        ep = p_samples + 1.0
    elif measure == "RKL":
        ep = -jnp.exp(-p_samples)
    elif measure == "DV":
        ep = p_samples
    elif measure == "H2":
        ep = 1.0 - jnp.exp(-p_samples)
    elif measure == "W1":
        ep = p_samples
    else:
        raise ValueError(measure)
    return jnp.mean(ep) if average else ep


def negative_expectation(q_samples, measure: str, average: bool = True):
    """NOTE: 'DV' reduces to a scalar logsumexp regardless of ``average``
    (matching the reference's formula, models/utils.py:144-145) — it is
    not per-sample decomposable; don't combine it with masked sums."""
    if measure == "GAN":
        eq = jax.nn.softplus(-q_samples) + q_samples
    elif measure == "JSD":
        eq = jax.nn.softplus(-q_samples) + q_samples - _LOG2
    elif measure == "X2":
        eq = -0.5 * ((jnp.sqrt(q_samples**2) + 1.0) ** 2)
    elif measure == "KL":
        eq = jnp.exp(q_samples)
    elif measure == "RKL":
        eq = q_samples - 1.0
    elif measure == "DV":
        eq = jax.nn.logsumexp(q_samples.reshape(-1), 0) - math.log(
            q_samples.size
        )
        return eq
    elif measure == "H2":
        eq = jnp.exp(q_samples) - 1.0
    elif measure == "W1":
        eq = q_samples
    else:
        raise ValueError(measure)
    return jnp.mean(eq) if average else eq


def fenchel_dual_loss(pos_scores, neg_scores, measure: str = "JSD"):
    """E_neg - E_pos (minimize => maximize the MI lower bound)."""
    return (negative_expectation(neg_scores, measure)
            - positive_expectation(pos_scores, measure))


class Mine(nn.Module):
    """MINE statistic network (models/utils.py:12-30)."""

    hidden: int = 128

    @nn.compact
    def __call__(self, x, y):
        h = jnp.concatenate([x, y], axis=-1)
        h = nn.relu(nn.Dense(self.hidden)(h))
        h = nn.relu(nn.Dense(self.hidden)(h))
        return nn.Dense(1)(h)[..., 0]
