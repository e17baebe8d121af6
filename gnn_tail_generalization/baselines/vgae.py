"""Variational Graph Auto-Encoder pretraining.

Reference parity: ``/root/reference/Link_prediction_baseline/models/vgae.py:37-168``
— two mean-SAGE encoder towers for mu / log sigma, inner-product decoder,
pos-weighted BCE over a sampled sub-adjacency + KL. (The reference file
imports src.models.MLP which does not exist in-repo; the working math is
reproduced, the broken import is not.)
"""
from __future__ import annotations

from ..nn import module as nn
import jax
import jax.numpy as jnp

from ..graph.core import Graph
from .encoders import GCNSAGELayer


class VGAE(nn.Module):
    hidden_dim: int
    latent_dim: int

    def setup(self):
        self.base = GCNSAGELayer(self.hidden_dim)
        self.mu_layer = GCNSAGELayer(self.latent_dim, activation=False)
        self.logstd_layer = GCNSAGELayer(self.latent_dim, activation=False)

    def encode(self, g: Graph, x):
        h = self.base(g, x)
        return self.mu_layer(g, h), self.logstd_layer(g, h)

    def embed(self, g: Graph, x):
        return self.encode(g, x)[0]

    def __call__(self, g: Graph, x, rng, batch_idx):
        """ELBO loss over the sub-adjacency of ``batch_idx`` (vgae.py's
        sampled sub-adjacency BCE + KL)."""
        mu, logstd = self.encode(g, x)
        z = mu + jnp.exp(logstd) * jax.random.normal(rng, mu.shape)

        zb = z[batch_idx]
        logits = zb @ zb.T
        # ground-truth sub-adjacency; reference semantics (vgae.py:100-110):
        # pos_weight and norm come from the SELF-LOOP-FREE sub adjacency,
        # the BCE label adds the identity back, and the weighted BCE is
        # scaled by norm = B^2 / (2 (B^2 - pos))
        adj = _sub_adjacency(g, batch_idx)
        b = batch_idx.shape[0]
        eye = jnp.eye(b, dtype=adj.dtype)
        adj_nosl = adj * (1.0 - eye)
        label = jnp.maximum(adj, eye)  # adj_label = sub + I
        pos = adj_nosl.sum()
        total = float(adj.size)
        pos_weight = (total - pos) / jnp.maximum(pos, 1.0)
        norm = total / jnp.maximum(2.0 * (total - pos), 1.0)
        w = jnp.where(label > 0, pos_weight, 1.0)
        bce = norm * jnp.mean(
            w * (jnp.maximum(logits, 0) - logits * label
                 + jnp.log1p(jnp.exp(-jnp.abs(logits))))
        )
        kl = -0.5 / x.shape[0] * jnp.mean(
            jnp.sum(1 + 2 * logstd - mu**2 - jnp.exp(logstd) ** 2, axis=1)
        )
        return bce + kl


def _sub_adjacency(g: Graph, batch_idx):
    """Dense [B, B] 0/1 adjacency among batch nodes."""
    b = batch_idx.shape[0]
    # membership: mark batch nodes, then accumulate edges between them
    pos_of = jnp.full((g.n_node,), -1, jnp.int32)
    pos_of = pos_of.at[batch_idx].set(jnp.arange(b, dtype=jnp.int32))
    src = pos_of[g.senders]
    dst = pos_of[g.receivers]
    ok = (src >= 0) & (dst >= 0) & (g.edge_weight != 0)
    src = jnp.where(ok, src, 0)
    dst = jnp.where(ok, dst, 0)
    a = jnp.zeros((b, b), jnp.float32).at[dst, src].add(
        ok.astype(jnp.float32)
    )
    return (a > 0).astype(jnp.float32)


def train_vgae(g: Graph, x, hidden_dim: int = 64, latent_dim: int = 32,
               batch_size: int = 256, epochs: int = 100, lr: float = 1e-3,
               seed: int = 0, log_every: int = 0):
    import optax

    model = VGAE(hidden_dim, latent_dim)
    n = x.shape[0]
    bsz = min(batch_size, n)
    k = jax.random.PRNGKey(seed)
    params = jax.jit(
        lambda g, x, bidx: model.init({"params": k}, g, x, k, bidx)
    )(g, x, jnp.arange(bsz, dtype=jnp.int32))["params"]
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, rng, g, x):
        k1, k2, k3 = jax.random.split(rng, 3)
        bidx = jax.random.permutation(k1, n)[:bsz]

        def loss_fn(p):
            return model.apply({"params": p}, g, x, k2, bidx)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    for ep in range(epochs):
        k, kk = jax.random.split(k)
        params, opt_state, loss = step(params, opt_state, kk, g, x)
        if log_every and ep % log_every == 0:
            print(f"vgae ep {ep}: loss={float(loss):.4f}")

    embs = jax.jit(
        lambda p, g, x: model.apply({"params": p}, g, x, method=model.embed)
    )(params, g, x)
    return jax.lax.stop_gradient(embs), params
