"""Deep Graph Infomax pretraining.

Reference parity: ``/root/reference/Link_prediction_baseline/models/dgi.py``
(GIN encoder + corruption by row permutation + bilinear discriminator
against the sigmoid-mean summary, BCE on positive/corrupted pairs;
the file's vestigial PAPI block that breaks import, dgi.py:1-15, is of
course not reproduced).
"""
from __future__ import annotations

from ..nn import module as nn
import jax
import jax.numpy as jnp

from ..graph.core import Graph
from .encoders import GINEncoder


class DGI(nn.Module):
    hidden_dim: int
    num_layers: int = 2

    def setup(self):
        self.encoder = GINEncoder(self.hidden_dim, self.num_layers)
        self.disc = nn.Dense(self.hidden_dim, use_bias=False)  # bilinear W

    def embed(self, g: Graph, x, *, train: bool = False):
        return self.encoder(g, x, train=train)

    def __call__(self, g: Graph, x, perm, *, train: bool = False):
        """Returns the DGI BCE loss. ``perm``: corruption row permutation."""
        pos = self.encoder(g, x, train=train)
        neg = self.encoder(g, x[perm], train=train)
        summary = jax.nn.sigmoid(jnp.mean(pos, axis=0))
        ws = self.disc(summary)  # [D]
        pos_logits = pos @ ws
        neg_logits = neg @ ws
        pos_loss = jnp.mean(jax.nn.softplus(-pos_logits))
        neg_loss = jnp.mean(jax.nn.softplus(neg_logits))
        return pos_loss + neg_loss


def train_dgi(g: Graph, x, hidden_dim: int = 64, num_layers: int = 2,
              epochs: int = 100, lr: float = 1e-3, seed: int = 0,
              patience: int = 20, log_every: int = 0):
    """run_airport.py-style loop (382-548): early stopping on best loss,
    return frozen embeddings."""
    import optax

    model = DGI(hidden_dim, num_layers)
    n = x.shape[0]
    k = jax.random.PRNGKey(seed)
    perm0 = jax.random.permutation(k, n)
    variables = jax.jit(
        lambda g, x, p0: model.init({"params": k}, g, x, p0, train=True)
    )(g, x, perm0)
    params, bs = variables["params"], variables.get("batch_stats")
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, bs, opt_state, rng, g, x):
        perm = jax.random.permutation(rng, n)

        def loss_fn(p):
            vs = {"params": p}
            if bs is not None:
                vs["batch_stats"] = bs
            out, nv = model.apply(
                vs, g, x, perm, train=True,
                mutable=["batch_stats"] if bs is not None else [],
            )
            return out, nv.get("batch_stats") if bs is not None else None

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, new_bs, opt_state, loss

    best_loss, best_params, best_bs, bad = jnp.inf, params, bs, 0
    for ep in range(epochs):
        k, kk = jax.random.split(k)
        params, bs, opt_state, loss = step(params, bs, opt_state, kk, g, x)
        lv = float(loss)
        if lv < float(best_loss):
            best_loss, best_params, best_bs, bad = lv, params, bs, 0
        else:
            bad += 1
            if bad >= patience:
                break
        if log_every and ep % log_every == 0:
            print(f"dgi ep {ep}: loss={lv:.4f}")

    vs = {"params": best_params}
    if best_bs is not None:
        vs["batch_stats"] = best_bs
    embs = jax.jit(
        lambda vs, g, x: model.apply(vs, g, x, train=False,
                                     method=model.embed)
    )(vs, g, x)
    return jax.lax.stop_gradient(embs), best_params
