"""EGI (Ego-Graph Infomax) pretraining with the faithful SubGI discriminator.

Reference parity: ``/root/reference/Link_prediction_baseline/models/subgi.py``
- SubGI.forward (385-458): GIN encoder, negatives = row-permuted embeddings,
  JSD loss E_neg/neg_num - E_pos/pos_num over per-hop edge scores.
- SubGDiscriminator (295-383) + GNNDiscLayer (267-293): walk the sampled
  ego NodeFlow from the seeds outward over REVERSED edges; at each hop,
  score every frontier edge with U_s(relu(W [root_src, m_src, x_dst]))
  BEFORE pushing messages, then update receivers with
  m_dst = relu(fc(x_dst) + mean(msg)) and root_dst = mean(root_src), where
  msg = fc(x_src) at hop 1 and fc(m_src) at deeper hops.

Static-shape formulation: the DGL NeighborSampler NodeFlow becomes a
host-built fixed-shape ``EgoFlows`` batch (padded per-hop edge lists with
weight-0 masking — the framework's universal padding mechanism), and the
per-hop push/reduce becomes masked segment means over [N]-sized state
tables, which exactly reproduces the reference's merged-subgraph semantics
(a batch's ego graphs share one small_g, so messages from different seeds
merge at shared nodes). The python hop loop is static (hops is a config),
so the whole step jits to one program per flow shape.

Documented deviation: the reference reuses ONE nn.Linear for both fc(x)
and fc(m), which only type-checks when in_feats == n_hidden (true for its
degree-bucketed airport runs); here fc_x [F->H] and fc_m [H->H] are
separate so arbitrary feature widths work.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np

from ..nn import module as nn
import jax
import jax.numpy as jnp

from ..graph.core import Graph
from .encoders import GINEncoder
from .mi import negative_expectation, positive_expectation


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["src", "dst", "mask"],
    meta_fields=["hops", "e_max"],
)
@dataclass(frozen=True)
class EgoFlows:
    """Padded per-hop reversed-edge lists of a batch of sampled ego graphs.
    Hop t edges run level-t node -> level-(t+1) node (seed side outward,
    i.e. the REVERSED orientation the SubGI discriminator walks)."""

    src: jax.Array  # [hops, e_max] int32 global node ids
    dst: jax.Array  # [hops, e_max] int32 global node ids
    mask: jax.Array  # [hops, e_max] f32 (0 = padding)
    hops: int = 2
    e_max: int = 0


def sample_ego_flows(edge_index: np.ndarray, n_node: int, seeds: np.ndarray,
                     hops: int, fanout: int, rng: np.random.Generator
                     ) -> EgoFlows:
    """Host-side NeighborSampler equivalent: from each seed, sample up to
    ``fanout`` in-neighbors per frontier node per hop (with replacement, as
    a fixed-shape formulation of DGL's expand_factor sampling). Frontier
    nodes without in-neighbors emit masked (weight-0) edges."""
    e = np.asarray(edge_index, np.int64)
    order = np.argsort(e[1], kind="stable")
    dst_sorted = e[1][order]
    src_sorted = e[0][order]
    indptr = np.searchsorted(dst_sorted, np.arange(n_node + 1))

    b = len(seeds)
    e_max = b * fanout ** hops
    src_h = np.zeros((hops, e_max), np.int32)
    dst_h = np.zeros((hops, e_max), np.int32)
    mask_h = np.zeros((hops, e_max), np.float32)

    frontier = np.asarray(seeds, np.int64)
    f_mask = np.ones(len(frontier), np.float32)
    for t in range(hops):
        lo = indptr[frontier]
        cnt = indptr[frontier + 1] - lo
        pick = (rng.random((len(frontier), fanout))
                * np.maximum(cnt, 1)[:, None]).astype(np.int64)
        neigh = src_sorted[np.minimum(lo[:, None] + pick,
                                      len(src_sorted) - 1)]
        emask = ((cnt > 0)[:, None] & (f_mask > 0)[:, None]).astype(
            np.float32) * np.ones((1, fanout), np.float32)
        ne = len(frontier) * fanout
        src_h[t, :ne] = np.repeat(frontier, fanout).astype(np.int32)
        dst_h[t, :ne] = neigh.reshape(-1).astype(np.int32)
        mask_h[t, :ne] = emask.reshape(-1)
        frontier = neigh.reshape(-1)
        f_mask = emask.reshape(-1)

    return EgoFlows(src=jnp.asarray(src_h), dst=jnp.asarray(dst_h),
                    mask=jnp.asarray(mask_h), hops=hops, e_max=e_max)


class SubGDiscriminator(nn.Module):
    """GNNDiscLayer + edge scoring head (subgi.py:267-383), hop loop
    unrolled over the EgoFlows levels."""

    hidden_dim: int

    @nn.compact
    def __call__(self, flows: EgoFlows, root_init, x):
        n = x.shape[0]
        fc_x = nn.Dense(self.hidden_dim, name="fc_x")
        fc_m = nn.Dense(self.hidden_dim, name="fc_m")
        lin = nn.Dense(self.hidden_dim, name="linear")
        u_s = nn.Dense(1, name="U_s")

        m = jnp.zeros((n, self.hidden_dim), x.dtype)
        root = root_init
        logits, masks = [], []
        for t in range(flows.hops):
            src = flows.src[t]
            dst = flows.dst[t]
            mask = flows.mask[t]
            # apply_edges BEFORE push: scores see pre-update m/root
            h_e = jnp.concatenate([root[src], m[src], x[dst]], axis=-1)
            logits.append(u_s(nn.relu(lin(h_e)))[..., 0])
            masks.append(mask)
            # push: msg = fc(x_src) at hop 1, fc(m_src) deeper
            msg = fc_x(x)[src] if t == 0 else fc_m(m)[src]
            w = mask[:, None]
            cnt = jax.ops.segment_sum(mask, dst, num_segments=n)
            denom = jnp.maximum(cnt, 1.0)[:, None]
            agg_m = jax.ops.segment_sum(msg * w, dst, num_segments=n) / denom
            agg_r = jax.ops.segment_sum(root[src] * w, dst,
                                        num_segments=n) / denom
            touched = (cnt > 0)[:, None]
            m = jnp.where(touched, nn.relu(fc_x(x) + agg_m), m)
            root = jnp.where(touched, agg_r, root)
        return jnp.stack(logits), jnp.stack(masks)


class EGI(nn.Module):
    """SubGI model_id=2 semantics: GIN encoder + ego-flow discriminator."""

    hidden_dim: int
    num_layers: int = 2
    measure: str = "JSD"

    def setup(self):
        # DV's negative expectation is a batch-level logsumexp (not
        # per-sample decomposable, matching the reference's formula), so it
        # cannot be combined with the masked per-edge sum below
        assert self.measure != "DV", "EGI requires a per-sample measure"
        self.encoder = GINEncoder(self.hidden_dim, self.num_layers)
        self.disc = SubGDiscriminator(self.hidden_dim)

    def embed(self, g: Graph, x, *, train: bool = False):
        return self.encoder(g, x, train=train)

    def __call__(self, g: Graph, x, flows: EgoFlows, perm, *,
                 train: bool = False):
        z = self.encoder(g, x, train=train)
        pos_logits, masks = self.disc(flows, z, x)
        neg_logits, _ = self.disc(flows, z[perm], x)
        pos_num = jnp.maximum(jnp.sum(masks), 1.0)
        e_pos = jnp.sum(
            positive_expectation(pos_logits, self.measure, average=False)
            * masks)
        e_neg = jnp.sum(
            negative_expectation(neg_logits, self.measure, average=False)
            * masks)
        return e_neg / pos_num - e_pos / pos_num


def train_egi(g: Graph, x, hidden_dim: int = 64, num_layers: int = 2,
              epochs: int = 100, lr: float = 1e-3, seed: int = 0,
              patience: int = 20, log_every: int = 0,
              edge_index: Optional[np.ndarray] = None,
              batch_seeds: int = 64, fanout: int = 5):
    """Train EGI; returns (embeddings, params). A fresh ego-flow batch is
    sampled per epoch (the reference's train_sampler loop, subgi.py:462),
    with a fixed shape so every epoch reuses one compiled step."""
    import optax

    model = EGI(hidden_dim, num_layers)
    n = x.shape[0]
    if edge_index is None:
        edge_index = np.stack([np.asarray(g.senders)[: g.n_edge],
                               np.asarray(g.receivers)[: g.n_edge]])
    nprng = np.random.default_rng(seed)
    b = min(batch_seeds, n)

    def sample():
        seeds = nprng.choice(n, size=b, replace=False)
        return sample_ego_flows(edge_index, n, seeds, num_layers, fanout,
                                nprng)

    k = jax.random.PRNGKey(seed)
    flows0 = sample()
    variables = jax.jit(
        lambda g, x, f, perm: model.init(
            {"params": k}, g, x, f, perm, train=True,
        )
    )(g, x, flows0, jnp.arange(n, dtype=jnp.int32))
    params, bs = variables["params"], variables.get("batch_stats")
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, bs, opt_state, rng, g, x, flows):
        perm = jax.random.permutation(rng, n)

        def loss_fn(p):
            vs = {"params": p}
            if bs is not None:
                vs["batch_stats"] = bs
            out, nv = model.apply(
                vs, g, x, flows, perm, train=True,
                mutable=["batch_stats"] if bs is not None else [],
            )
            return out, nv.get("batch_stats") if bs is not None else None

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, new_bs, opt_state, loss

    best_loss, best, bad = jnp.inf, (params, bs), 0
    for ep in range(epochs):
        k, kk = jax.random.split(k)
        flows = sample() if ep else flows0
        params, bs, opt_state, loss = step(params, bs, opt_state, kk, g, x,
                                           flows)
        lv = float(loss)
        if lv < float(best_loss):
            best_loss, best, bad = lv, (params, bs), 0
        else:
            bad += 1
            if bad >= patience:
                break
        if log_every and ep % log_every == 0:
            print(f"egi ep {ep}: loss={lv:.4f}")

    params, bs = best
    vs = {"params": params}
    if bs is not None:
        vs["batch_stats"] = bs
    embs = jax.jit(
        lambda vs, g, x: model.apply(vs, g, x, train=False,
                                     method=model.embed)
    )(vs, g, x)
    return jax.lax.stop_gradient(embs), params
