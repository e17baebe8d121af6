"""Correct & Smooth pipeline: PreStep -> MidStep -> LPStep.

Reference parity: ``/root/reference/Label_propagation_model/LP_Adj.py:18-224``
- PreStep (162-178): concat of diffusion/spectral/community features
- MidStep (180-224): BatchNorm-MLP (or linear) on [x, embs], log_softmax,
  trained full-batch; keeps best-by-valid exp(out)
- LPStep (109-160): Correct&Smooth via double_correlation_{fixed,autoscale}
  or only_outcome_correlation on the configured DAD/DA/AD graphs; the
  reference's ``eval()`` of config strings and forced CPU offload
  (lp_force_on_cpu, LP_Adj.py:149-152) are gone — names map through a dict
  and the propagation loops run jitted on device.

no_prep=True (the LP-only default, base_options.py:397-402) routes to plain
label_propagation from train labels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..nn import module as nn
import jax
import jax.numpy as jnp
import optax

from ..config import Config
from ..data.datasets import PreparedData
from . import correlation as corr
from . import diffusion as diff


class CSMLp(nn.Module):
    """MidStep 'mlp' model (diffusion_feature.py:20-51): Linear ->
    [relu -> BN -> dropout] x (L-1) -> Linear -> log_softmax."""

    hidden: int
    out: int
    num_layers: int
    dropout: float = 0.5

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        for i in range(self.num_layers - 1):
            x = nn.Dense(self.hidden)(x)
            x = nn.relu(x)
            x = nn.BatchNorm(use_running_average=not train, momentum=0.9)(x)
            x = nn.Dropout(self.dropout, deterministic=not train)(x)
        x = nn.Dense(self.out)(x)
        return jax.nn.log_softmax(x, axis=-1)


class CSLinear(nn.Module):
    out: int

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        return jax.nn.log_softmax(nn.Dense(self.out)(x), axis=-1)


def pre_step(cfg: Config, data: PreparedData,
             cache_dir: str | None = None) -> np.ndarray:
    """PreStep.forward (LP_Adj.py:168-178). ``cache_dir`` mirrors the
    reference's per-method embedding cache (diffusion_feature.py:132-140:
    ``LP/embeddings/<method><dataset>.pt``) as npy files keyed by method,
    propagation count, and graph shape."""
    import os

    embs = []
    methods = cfg.preStep.pre_methods.split("+")
    for m in methods:
        path = None
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
            key = (f"{m}_{cfg.dataset}_{cfg.preStep.num_propagations}"
                   f"_{data.n_node}_{data.edge_index.shape[1]}")
            path = os.path.join(cache_dir, f"{key}.npy")
            if os.path.exists(path):
                embs.append(np.load(path))
                continue
        emb = diff.preprocess(
            m, data.x, data.edge_index, data.n_node,
            labels=data.y, train_idx=data.train_idx,
            num_propagations=cfg.preStep.num_propagations,
        )
        if path is not None:
            np.save(path, emb)
        embs.append(emb)
    return np.concatenate(embs, axis=-1)


def lp_step(cfg: Config, data: PreparedData, model_out: jax.Array,
            label_idx, residual_idx) -> jax.Array:
    """LPStep.forward (LP_Adj.py:146-160).

    Every propagation runs under jit with the adjacency Graph(s) passed as
    ARGUMENTS: eager fori_loops would close over the device edge arrays
    and hoist them as lowered-module constants (a host readback at
    lowering time). Only the needed graphs are built."""
    lp = cfg.lpStep
    nc = cfg.num_classes
    need = {lp.A} if (lp.no_prep or lp.fn == "only_outcome_correlation") \
        else {lp.A1, lp.A2}
    adjs = corr.gen_normalized_adjs(data.edge_index, data.n_node,
                                    which=need)
    by_name = {k: v for k, v in zip(("DAD", "DA", "AD"), adjs)
               if v is not None}
    if lp.no_prep:
        f = jax.jit(corr.label_propagation, static_argnums=(3, 4, 5, 6))
        return f(jnp.asarray(data.y), jnp.asarray(data.train_idx),
                 by_name[lp.A], lp.alpha, lp.num_propagations, nc, "gather")
    if lp.fn == "double_correlation_autoscale":
        f = jax.jit(corr.double_correlation_autoscale,
                    static_argnums=(5, 6, 8, 9, 10, 11))
        _, out = f(jnp.asarray(data.y), model_out, label_idx, residual_idx,
                   by_name[lp.A1], lp.alpha1, lp.num_propagations1,
                   by_name[lp.A2], lp.alpha2, lp.num_propagations2, nc,
                   "gather")
    elif lp.fn == "double_correlation_fixed":
        f = jax.jit(corr.double_correlation_fixed,
                    static_argnums=(5, 6, 8, 9, 10, 11, 12))
        _, out = f(jnp.asarray(data.y), model_out, label_idx, residual_idx,
                   by_name[lp.A1], lp.alpha1, lp.num_propagations1,
                   by_name[lp.A2], lp.alpha2, lp.num_propagations2, nc,
                   1.0, "gather")
    else:
        f = jax.jit(corr.only_outcome_correlation,
                    static_argnums=(4, 5, 6, 7))
        _, out = f(jnp.asarray(data.y), model_out, label_idx,
                   by_name[lp.A], lp.alpha, lp.num_propagations, nc, "gather")
    return out


def run_cs_pipeline(cfg: Config, data: PreparedData, seed: int = 0,
                    epochs: int = 100, log_every: int = 0) -> Dict:
    """LabelPropagation_Adj.train_net loop (LP_Adj.py:37-66) run to
    completion: preprocess once, train the mid MLP full-batch, C&S the best
    validated output."""
    cfg = dataclasses.replace(
        cfg, lpStep=dataclasses.replace(cfg.lpStep, no_prep=False)
    )
    embs = pre_step(cfg, data)
    x = jnp.asarray(np.concatenate([data.x, embs], axis=-1))
    y = jnp.asarray(data.y)
    train_mask = jnp.asarray(data.train_mask)
    val_mask = jnp.asarray(
        data.val_mask if data.val_mask is not None else ~data.train_mask
    )
    test_mask = jnp.asarray(data.test_mask)

    if cfg.midStep.model == "mlp":
        model = CSMLp(cfg.midStep.hidden_channels, cfg.num_classes,
                      cfg.midStep.num_layers)
    else:
        model = CSLinear(cfg.num_classes)

    k = jax.random.PRNGKey(seed)
    variables = jax.jit(
        lambda x: model.init({"params": k, "dropout": k}, x, train=True)
    )(x)
    params, bs = variables["params"], variables.get("batch_stats")
    tx = optax.adam(cfg.lr)
    opt_state = tx.init(params)

    def loss_fn(params, bs, rng, x):
        vs = {"params": params}
        if bs is not None:
            vs["batch_stats"] = bs
        mutable = ["batch_stats"] if bs is not None else []
        out, nv = model.apply(vs, x, train=True, rngs={"dropout": rng},
                              mutable=mutable)
        picked = jnp.take_along_axis(out, y[:, None], axis=1)[:, 0]
        m = train_mask.astype(jnp.float32)
        loss = -jnp.sum(picked * m) / jnp.maximum(m.sum(), 1.0)
        return loss, nv.get("batch_stats") if mutable else bs

    @jax.jit
    def step(params, bs, opt_state, rng, x):
        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, bs, rng, x
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        vs = {"params": params}
        if new_bs is not None:
            vs["batch_stats"] = new_bs
        out = model.apply(vs, x, train=False)
        pred = jnp.argmax(out, axis=1)
        accs = {
            "train": _macc(pred, y, train_mask),
            "valid": _macc(pred, y, val_mask),
            "test": _macc(pred, y, test_mask),
        }
        return params, new_bs, opt_state, loss, out, accs

    best_valid, best_out = -1.0, None
    for ep in range(epochs):
        k, kk = jax.random.split(k)
        params, bs, opt_state, loss, out, accs = step(params, bs, opt_state,
                                                      kk, x)
        v = float(accs["valid"])
        if v > best_valid:
            best_valid = v
            best_out = jnp.exp(out)  # MidStep keeps exp of log_softmax
        if log_every and ep % log_every == 0:
            print(f"cs ep {ep}: loss={float(loss):.4f} "
                  f"val={v:.3f} test={float(accs['test']):.3f}")

    label_idx = jnp.asarray(np.concatenate(
        [data.train_idx]  # train_only=True (LP_Adj.py:127)
    ))
    out = lp_step(cfg, data, best_out, label_idx, label_idx)
    pred = jnp.argmax(out, axis=1)
    return {
        "acc_train": float(_macc(pred, y, train_mask)) * 100,
        "acc_test": float(_macc(pred, y, test_mask)) * 100,
        "acc_valid_mid": best_valid * 100,
        "out": out,
    }


def _macc(pred, y, mask):
    m = mask.astype(jnp.float32)
    return jnp.sum((pred == y) * m) / jnp.maximum(m.sum(), 1.0)
