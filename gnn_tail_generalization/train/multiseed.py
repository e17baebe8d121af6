"""Vmapped multi-seed teacher training — N_exp seeds in one compiled step.

The reference runs its ``--N_exp`` seed loop sequentially
(reference ``main.py:23-36``); on an accelerator the seeds are embarrassingly
parallel, so the whole population trains as ONE vmapped jitted step over
stacked parameters: S models' forward+backward+Adam fused per epoch. On
small graphs (Cora-class) this turns N_exp runs into ~1 run of wall-clock.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
import optax

from ..config import Config
from ..data.datasets import PreparedData
from ..models.teacher import TeacherGNN
from .evalutil import headtail_accuracies, masked_accuracy
from .loops import TrainResult, _nll_masked, _split_masks
from .optim import make_optimizer


def train_teacher_multiseed(
    cfg: Config,
    data: PreparedData,
    seeds: Sequence[int],
    epochs: Optional[int] = None,
    log_every: int = 0,
) -> List[TrainResult]:
    epochs = epochs if epochs is not None else cfg.epochs
    n_seeds = len(seeds)
    ew_fn = None
    if cfg.has_loss_component_edgewise:
        from .edgewise import (
            build_edgewise_plan, edgewise_consts, make_edgewise_loss_fn,
        )

        _ew_plan = build_edgewise_plan(cfg, data)
        ew_fn = make_edgewise_loss_fn(_ew_plan)
    const = {
        "g": data.graph,
        "x": jnp.asarray(data.x),
        "y": jnp.asarray(data.y),
        "test_mask": jnp.asarray(data.test_mask),
    }
    train_mask, large, small, zero = _split_masks(data)
    const["train_mask"] = train_mask
    want_ht = cfg.want_headtail and data.splits is not None
    if want_ht:
        const["large"] = large
        const["small"] = small
        if zero is not None:
            const["zero"] = zero

    if ew_fn is not None:
        const["ew"] = edgewise_consts(_ew_plan)
    model = TeacherGNN(cfg)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])

    def init_one(k, c):
        return model.init(
            {"params": k, "dropout": k, "graph_dropout": k},
            c["g"], c["x"], train=True,
        )

    variables = jax.jit(jax.vmap(init_one, in_axes=(0, None)))(keys, const)
    params = variables["params"]
    has_bs = "batch_stats" in variables
    batch_stats = variables.get("batch_stats")
    tx = make_optimizer(cfg)
    opt_state = jax.vmap(tx.init)(params)

    def step_one(params, batch_stats, opt_state, rng, c):
        def loss_fn(p, bs):
            vs = {"params": p}
            if bs is not None:
                vs["batch_stats"] = bs
            mutable = ["batch_stats"] if bs is not None else []
            out, nv = model.apply(
                vs, c["g"], c["x"], train=True,
                rngs={"dropout": rng,
                      "graph_dropout": jax.random.fold_in(rng, 1)},
                mutable=mutable,
            )
            common, classi, se_reg_all, _ = out
            loss = 0.0
            linkp_train = 0.0
            if cfg.has_loss_component_nodewise:
                loss = _nll_masked(classi, c["y"], c["train_mask"]) \
                    * cfg.TeacherGNN.lossa_semantic
            if se_reg_all is not None:
                loss = loss + cfg.se_reg * se_reg_all
            if ew_fn is not None:
                l_struct, linkp_train = ew_fn(
                    common, jax.random.fold_in(rng, 2), "train", c["ew"])
                loss = loss + l_struct * cfg.TeacherGNN.lossa_structure
            return loss, (nv.get("batch_stats") if mutable else bs,
                          linkp_train)

        (loss, (new_bs, linkp_train)), grads = jax.value_and_grad(
            lambda p: loss_fn(p, batch_stats), has_aux=True
        )(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        vs = {"params": params}
        if new_bs is not None:
            vs["batch_stats"] = new_bs
        common_eval, classi, _, _ = model.apply(vs, c["g"], c["x"],
                                                train=False)
        metrics = {
            "loss_train": loss,
            "acc_train": masked_accuracy(classi, c["y"], c["train_mask"]) * 100,
            "acc_test": masked_accuracy(classi, c["y"], c["test_mask"]) * 100,
        }
        if want_ht:
            metrics.update(headtail_accuracies(
                classi, c["y"], c["train_mask"], c["large"], c["small"],
                c.get("zero")))
        if ew_fn is not None:
            _, linkp_test = ew_fn(
                common_eval, jax.random.fold_in(rng, 5), "test", c["ew"])
            metrics["linkp_train"] = linkp_train
            metrics["linkp_test"] = linkp_test
        mvec = jnp.stack([jnp.asarray(metrics[c2], jnp.float32)
                          for c2 in cols])
        return params, new_bs, opt_state, mvec

    cols = ["loss_train", "acc_train", "acc_test"] + (
        ["head", "tail"] + (["iso"] if zero is not None else [])
        if want_ht else []
    ) + (["linkp_train", "linkp_test"] if ew_fn is not None else [])

    bs_axes = 0 if has_bs else None
    vstep = jax.jit(jax.vmap(
        step_one, in_axes=(0, bs_axes, 0, 0, None)
    ))
    records = np.zeros((n_seeds, epochs, len(cols)))
    run_keys = keys
    for epoch in range(epochs):
        run_keys = jax.vmap(lambda k: jax.random.fold_in(k, 7))(run_keys)
        params, batch_stats, opt_state, m = vstep(
            params, batch_stats, opt_state, run_keys, const
        )
        records[:, epoch, :] = np.asarray(m)  # [S, n_cols], one pull
        if log_every and epoch % log_every == 0:
            print(f"[multiseed] ep {epoch}: acc_test="
                  f"{records[:, epoch, 2].round(2).tolist()}")

    results = []
    for si in range(n_seeds):
        p_i = jax.tree.map(lambda a, si=si: a[si], params)
        vs = {"params": p_i}
        if has_bs:
            vs["batch_stats"] = jax.tree.map(
                lambda a, si=si: a[si], batch_stats)
        results.append(TrainResult(
            columns=cols, records=records[si], variables=vs,
            best_variables=vs,
        ))
    return results
