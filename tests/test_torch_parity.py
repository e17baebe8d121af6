"""Cross-framework parity: per-layer activations vs an independent torch
implementation of the documented math (BASELINE.md: 'per-layer activations
allclose vs PyTorch-Geometric reference').

The torch model here is written from the documented formulas
(GNN_model/GCN.py:205-250: X' = D_in^-1/2 A (D_out^-1/2 X W + E) + b), not
copied from the reference; weights are transplanted from the JAX params so
both frameworks compute the same function.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from gnn_tail_generalization.graph import core
from gnn_tail_generalization.nn.backbone import TricksCombBackbone


def build_graph(rng, n=30):
    src = rng.integers(0, n, 120)
    dst = rng.integers(0, n, 120)
    ei = core.standard_pipeline(np.stack([src, dst]), n)
    return core.build_graph(ei, n), ei


class TorchGCN(torch.nn.Module):
    """Independent torch implementation of the 2-layer SE-GCN math."""

    def __init__(self, weights, n, ei):
        super().__init__()
        self.w = [torch.tensor(np.asarray(w)) for w in weights["w"]]
        self.b = [torch.tensor(np.asarray(b)) for b in weights["b"]]
        self.se = [None if s is None else torch.tensor(np.asarray(s))
                   for s in weights["se"]]
        dout = np.maximum(np.bincount(ei[0], minlength=n), 1.0)
        din = np.maximum(np.bincount(ei[1], minlength=n), 1.0)
        self.outn = torch.tensor(dout ** -0.5).float().unsqueeze(1)
        self.inn = torch.tensor(din ** -0.5).float().unsqueeze(1)
        a = np.zeros((n, n), np.float32)
        np.add.at(a, (ei[1], ei[0]), 1.0)
        self.a = torch.tensor(a)

    def layer(self, x, i, relu):
        h = (x * self.outn) @ self.w[i]
        if self.se[i] is not None:
            h = h + self.se[i]
        y = (self.a @ h) * self.inn + self.b[i]
        return torch.relu(y) if relu else y

    def forward(self, x):
        acts = []
        h = self.layer(x, 0, relu=False)
        acts.append(h)
        h = torch.relu(h)
        h = self.layer(h, 1, relu=False)
        acts.append(h)
        return acts


def test_per_layer_allclose_with_torch(rng):
    n = 30
    g, ei = build_graph(rng, n)
    x = rng.normal(size=(n, 10)).astype(np.float32)

    bb = TricksCombBackbone(
        num_feats=10, num_classes=4, dim_hidden=8, num_layers=2, n_node=n,
        type_trick="NoResNodeNorm", dropout=0.0, whetherHasSE=(1, 0, 0),
    )
    vs = bb.init(jax.random.PRNGKey(0), g, jnp.asarray(x), train=False)
    _, _, les = bb.apply(vs, g, jnp.asarray(x), train=False, want_les=True)
    jax_acts = [np.asarray(les[:, :8]), np.asarray(les[:, 8:])]

    p = vs["params"]
    weights = {
        "w": [p["conv_0"]["kernel"], p["conv_1"]["kernel"]],
        "b": [p["conv_0"]["bias"], p["conv_1"]["bias"]],
        "se": [p["conv_0"]["se"], None],
    }
    tm = TorchGCN(weights, n, ei)
    with torch.no_grad():
        torch_acts = tm(torch.tensor(x))

    for i in range(2):
        np.testing.assert_allclose(
            jax_acts[i], torch_acts[i].numpy(), rtol=2e-4, atol=2e-4,
            err_msg=f"layer {i} mismatch",
        )


def test_adam_update_matches_torch(rng):
    """One optimizer step parity: torch.optim.Adam(weight_decay) vs the
    optax chain of train/optim.py (L2-coupled, not AdamW)."""
    import optax

    from gnn_tail_generalization.config import build_config
    from gnn_tail_generalization.train.optim import make_optimizer

    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grad = rng.normal(size=(5, 3)).astype(np.float32)

    cfg = build_config(dataset="Cora", train_which="TeacherGNN")
    tx = make_optimizer(cfg, lr=0.01, weight_decay=5e-4)
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    updates, state = tx.update({"w": jnp.asarray(grad)}, state, params)
    jax_w1 = np.asarray(params["w"] + updates["w"])

    tw = torch.nn.Parameter(torch.tensor(w0))
    opt = torch.optim.Adam([tw], lr=0.01, weight_decay=5e-4)
    tw.grad = torch.tensor(grad)
    opt.step()
    np.testing.assert_allclose(jax_w1, tw.detach().numpy(), rtol=1e-5,
                               atol=1e-6)


def test_training_dynamics_match_torch(rng):
    """Several full Adam steps in BOTH frameworks from a transplanted
    init: per-step losses and final parameters must track. Catches
    optimizer-chain, gradient, and masking discrepancies that single-step
    or forward-only parity misses."""
    import dataclasses

    from gnn_tail_generalization.config import build_config
    from gnn_tail_generalization.data.datasets import NodeData, prepare
    from gnn_tail_generalization.train import loops

    n, f, h, c = 40, 12, 8, 4
    src = rng.integers(0, n, 160)
    dst = rng.integers(0, n, 160)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.integers(0, c, n)
    train = np.zeros(n, bool)
    train[: n // 2] = True

    cfg = build_config(dataset="Cora", train_which="TeacherGNN",
                       whetherHasSE="100", se_reg=0.5)
    cfg = dataclasses.replace(
        cfg, N_nodes=n, num_feats=f, num_classes=c, dim_hidden=h,
        dropout=0.0, type_trick="NoResNoNorm", lr=0.01, weight_decay=5e-4,
        use_special_split=False, do_deg_analyze=False, want_headtail=False,
        has_loss_component_nodewise=True,
    )
    data = NodeData(x=x, y=y, edge_index=np.stack([src, dst]),
                    train_mask=train, val_mask=None, test_mask=~train,
                    name="dyn-parity")
    pd = prepare(data, cfg)
    steps = 6
    res = loops.train_teacher(cfg, pd, seed=0, epochs=steps)
    jax_losses = res.records[:, 0]
    p = res.variables["params"]["backbone"]

    # --- independent torch replica, same init, same objective ----------
    import jax

    init = loops.train_teacher(cfg, pd, seed=0, epochs=0)  # params at init
    pi = init.variables["params"]["backbone"]
    ei = pd.edge_index
    tm = TorchGCN(
        {"w": [pi["conv_0"]["kernel"], pi["conv_1"]["kernel"]],
         "b": [pi["conv_0"]["bias"], pi["conv_1"]["bias"]],
         "se": [pi["conv_0"]["se"], None]},
        n, ei,
    )
    for w in tm.w + tm.b:
        w.requires_grad_(True)
    tm.se[0].requires_grad_(True)
    tparams = tm.w + tm.b + [tm.se[0]]
    opt = torch.optim.Adam(tparams, lr=0.01, weight_decay=5e-4)
    tx = torch.tensor(x)
    ty = torch.tensor(y).long()
    tmask = torch.tensor(train)

    torch_losses = []
    for _ in range(steps):
        opt.zero_grad()
        h1 = torch.relu(tm.layer(tx, 0, relu=False))
        logits = tm.layer(h1, 1, relu=False)
        lsm = torch.log_softmax(logits, dim=1)
        nll = -(lsm[tmask, ty[tmask]]).mean()
        loss = nll + 0.5 * torch.norm(tm.se[0])
        loss.backward()
        opt.step()
        torch_losses.append(float(loss))

    np.testing.assert_allclose(jax_losses, torch_losses, rtol=2e-3,
                               atol=2e-3)
    final = {"w0": p["conv_0"]["kernel"], "se": p["conv_0"]["se"],
             "w1": p["conv_1"]["kernel"]}
    for name, ours, theirs in (
        ("w0", final["w0"], tm.w[0]), ("w1", final["w1"], tm.w[1]),
        ("se", final["se"], tm.se[0]),
    ):
        np.testing.assert_allclose(
            np.asarray(ours), theirs.detach().numpy(), rtol=5e-3, atol=5e-3,
            err_msg=name)
