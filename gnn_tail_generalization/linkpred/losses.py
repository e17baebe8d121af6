"""Link-prediction losses (/root/reference/Link_prediction_model/loss.py:4-30).

Every loss takes an optional ``valid`` weight vector (one per positive
edge, broadcast over that edge's negatives). The train loop uses it to
zero out wrap-filled entries of the final partial batch so a positive
edge never contributes gradient twice per epoch while the step keeps one
static shape (the reference's drop_last=False DataLoader trains a true
partial batch, model.py:144). Mean-type losses renormalize by the number
of valid rows so gradient scale matches a true partial batch.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax.nn import log_sigmoid, sigmoid

_LOG_EPS = float(np.log(1e-15))


def _log_sig_eps(x):
    """log(sigmoid(x) + 1e-15), computed stably as
    logaddexp(log_sigmoid(x), log(1e-15)). The naive form is exact in
    eager mode but XLA's fused lowering produces inf once sigmoid
    saturates (|score| ~ a few hundred, routine for DOT predictors at
    ogbl scale — found by the citation2 bench)."""
    return jnp.logaddexp(log_sigmoid(x), _LOG_EPS)


def _valid_col(valid, n_rows):
    if valid is None:
        return jnp.ones((n_rows, 1))
    return valid.reshape(-1, 1)


def auc_loss(pos_out, neg_out, num_neg, valid=None):
    pos = pos_out.reshape(-1, 1)
    neg = neg_out.reshape(-1, num_neg)
    v = _valid_col(valid, pos.shape[0])
    return jnp.sum(v * jnp.square(1 - (pos - neg)))


def adaptive_auc_loss(pos_out, neg_out, num_neg, weight, valid=None):
    w = weight.reshape(-1, 1)
    pos = pos_out.reshape(-1, 1)
    neg = neg_out.reshape(-1, num_neg)
    v = _valid_col(valid, pos.shape[0])
    return jnp.sum(v * w * jnp.square(1 - (pos - neg)))


def log_rank_loss(pos_out, neg_out, num_neg, valid=None):
    pos = pos_out.reshape(-1, 1)
    neg = neg_out.reshape(-1, num_neg)
    v = _valid_col(valid, pos.shape[0])
    terms = v * _log_sig_eps(pos - neg)
    return -jnp.sum(terms) / jnp.maximum(jnp.sum(v) * num_neg, 1.0)


def ce_loss(pos_out, neg_out, valid=None, num_neg: int = 1):
    # log(1 - sigmoid(x) + eps) == log(sigmoid(-x) + eps)
    pos = pos_out.reshape(-1)
    if valid is None:
        pos_loss = -jnp.mean(_log_sig_eps(pos))
        neg_loss = -jnp.mean(_log_sig_eps(-neg_out))
        return pos_loss + neg_loss
    v = valid.reshape(-1)
    denom = jnp.maximum(jnp.sum(v), 1.0)
    pos_loss = -jnp.sum(v * _log_sig_eps(pos)) / denom
    vneg = jnp.repeat(v, num_neg, total_repeat_length=v.shape[0] * num_neg)
    neg = neg_out.reshape(-1)
    neg_loss = (-jnp.sum(vneg * _log_sig_eps(-neg))
                / jnp.maximum(jnp.sum(vneg), 1.0))
    return pos_loss + neg_loss


def info_nce_loss(pos_out, neg_out, num_neg, valid=None):
    pos = pos_out.reshape(-1, 1)
    neg = neg_out.reshape(-1, num_neg)
    v = _valid_col(valid, pos.shape[0])
    # log(softmax_pos + eps), with the softmax in log space: exp(pos)
    # overflows f32 beyond score ~88 (routine at ogbl scale)
    from jax.nn import logsumexp

    lse = logsumexp(jnp.concatenate([pos, neg], axis=1), axis=1,
                    keepdims=True)
    log_sm = pos - lse
    terms = v * jnp.logaddexp(log_sm, _LOG_EPS)
    return -jnp.sum(terms) / jnp.maximum(jnp.sum(v), 1.0)


LOSSES = {
    "AUC": auc_loss,
    "ce_loss": ce_loss,
    "log_rank_loss": log_rank_loss,
    "info_nce_loss": info_nce_loss,
}
