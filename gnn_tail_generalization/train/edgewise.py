"""Edgewise (link-prediction) auxiliary loss for the teacher.

Reference parity: ``/root/reference/trainer_node_classification.py:435-563``
and ``/root/reference/utils.py:754-791``:
- gen_pn_edges (507-532): positive edges sampled (with replacement,
  samp_size_p) from edges whose endpoints BOTH lie in the split (train:
  both in train_mask; test: both outside)
- my_negative_sampling (534-563): rejection-sampled non-edges filtered by
  the split membership (train: both endpoints in train; test: NOT both in
  train)
- calc_score (754-757): DistMult sum(h_src * h_dst)
- linkp_loss_eva (759-774): BCE-with-logits over pos/neg scores + MRR
- cal_MRR (776-791): negatives grouped per positive, reciprocal rank

Static shapes: the reference's while-loop rejection sampling becomes
fixed-rounds masked resampling (see linkpred/sampling.py); every shape is
static. MRR uses the optimistic rank (1 + #neg strictly greater) — the
reference's sort-based rank differs only on exact score ties.
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np

import jax
import jax.numpy as jnp

from ..config import Config
from ..data.datasets import PreparedData
from ..linkpred import sampling
from ..ops.sddmm import edge_dot


@dataclass(frozen=True)
class EdgewisePlan:
    """Host-prepared static data for the edgewise loss."""

    train_edges: np.ndarray  # [2, Et] both endpoints in train
    test_edges: np.ndarray  # [2, Ev] both endpoints outside train
    keys_sorted: np.ndarray  # hashed edge set for negative rejection
    train_mask: np.ndarray
    n_node: int
    samp_size_p: int
    samp_size_n_train: int
    samp_size_n_test: int


def build_edgewise_plan(cfg: Config, data: PreparedData) -> EdgewisePlan:
    e = data.edge_index
    # sharded PreparedData carries device/padded masks and padded x — pull
    # the (tiny) mask to host and use the graph's REAL node count so
    # negatives never hit padding rows
    tm = np.asarray(data.train_mask)
    n_node = getattr(data.graph, "n_node", None) or data.n_node
    tm = tm[:n_node]
    both_train = tm[e[0]] & tm[e[1]]
    both_test = (~tm)[e[0]] & (~tm)[e[1]]
    return EdgewisePlan(
        train_edges=e[:, both_train],
        test_edges=e[:, both_test],
        keys_sorted=sampling.edge_keys(e, n_node),
        train_mask=tm,
        n_node=n_node,
        samp_size_p=cfg.samp_size_p,
        samp_size_n_train=cfg.samp_size_n_train,
        samp_size_n_test=cfg.samp_size_p * cfg.samp_size_n_test_times_p,
    )


def _sample_split_negatives(rng, keys_sorted, train_mask, train_idx,
                            test_idx, n_node: int, count: int, mode: str,
                            rounds: int = 3):
    """Uniform non-edges constrained to the split (trainer:534-563):
    train -> both endpoints in train; test -> not both in train.

    Fixed-shape scheme: a few uniform redraw rounds, then a constrained
    fallback draw straight from the split index sets for any survivor
    (edge-membership collisions after that are vanishingly rare)."""

    def draw(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.randint(k1, (count,), 0, n_node),
                jax.random.randint(k2, (count,), 0, n_node))

    def invalid(src, dst):
        bad = sampling._is_member(keys_sorted, src, dst)
        both_train = train_mask[src] & train_mask[dst]
        if mode == "train":
            return bad | ~both_train
        return bad | both_train

    src, dst = draw(rng)
    for i in range(rounds):
        k = jax.random.fold_in(rng, i + 1)
        s2, d2 = draw(k)
        bad = invalid(src, dst)
        src = jnp.where(bad, s2, src)
        dst = jnp.where(bad, d2, dst)
    # constrained fallback for the rest
    kf = jax.random.fold_in(rng, 99)
    k1, k2 = jax.random.split(kf)
    if mode == "train":
        s2 = train_idx[jax.random.randint(k1, (count,), 0, train_idx.shape[0])]
        d2 = train_idx[jax.random.randint(k2, (count,), 0, train_idx.shape[0])]
    else:
        # dst in the non-train set guarantees "not both train"
        s2 = jax.random.randint(k1, (count,), 0, n_node)
        d2 = test_idx[jax.random.randint(k2, (count,), 0, test_idx.shape[0])]
    bad = invalid(src, dst)
    src = jnp.where(bad, s2, src)
    dst = jnp.where(bad, d2, dst)
    return src, dst


def linkp_loss_eva(pos_score, neg_score):
    """BCE-with-logits + MRR (utils.py:759-791)."""
    score = jnp.concatenate([pos_score, neg_score])
    label = jnp.concatenate(
        [jnp.ones_like(pos_score), jnp.zeros_like(neg_score)]
    )
    # binary_cross_entropy_with_logits, mean reduction
    loss = jnp.mean(
        jnp.maximum(score, 0) - score * label + jnp.log1p(jnp.exp(-jnp.abs(score)))
    )
    p = pos_score.shape[0]
    npg = neg_score.shape[0] // p
    negs = neg_score[: npg * p].reshape(p, npg)
    rank = 1 + jnp.sum(negs > pos_score[:, None], axis=1)
    mrr = jnp.mean(1.0 / rank)
    return loss, mrr


def edgewise_consts(plan: EdgewisePlan):
    """Device arrays of the plan, to ride in the train step's const dict —
    never as closures (closure device arrays become lowered-module
    constants: host readback at lowering time + executable bloat)."""
    return {
        "train_edges": jnp.asarray(plan.train_edges),
        "test_edges": jnp.asarray(plan.test_edges),
        "keys_sorted": jnp.asarray(plan.keys_sorted),
        "train_mask": jnp.asarray(plan.train_mask),
        "train_idx": jnp.asarray(np.where(plan.train_mask)[0]),
        "test_idx": jnp.asarray(np.where(~plan.train_mask)[0]),
    }


def make_edgewise_loss_fn(plan: EdgewisePlan, dist_graph=None):
    """Returns f(h, rng, mode, ew) -> (loss, mrr), fully jittable; ``ew``
    is the edgewise_consts(plan) dict passed through the step arguments.
    ``h``: full node embeddings (commonEmb — trainer:418 uses the unmasked
    embedding). Only static plan SIZES are closed over.

    ``dist_graph``: a parallel.distgraph.DistGraph when ``h`` is
    row-sharded — the sampled pair rows are then assembled with ONE psum
    of [4K, d] floats (dist_take_rows) instead of letting GSPMD
    all-gather the whole embedding table for four tiny gathers."""

    def f(h, rng, mode: str, ew):
        edges = ew["train_edges"] if mode == "train" else ew["test_edges"]
        n_neg = (plan.samp_size_n_train if mode == "train"
                 else plan.samp_size_n_test)
        k1, k2 = jax.random.split(rng)
        pick = jax.random.randint(
            k1, (plan.samp_size_p,), 0, edges.shape[1]
        )
        pos_src, pos_dst = edges[0][pick], edges[1][pick]
        neg_src, neg_dst = _sample_split_negatives(
            k2, ew["keys_sorted"], ew["train_mask"], ew["train_idx"],
            ew["test_idx"], plan.n_node, n_neg, mode
        )
        if dist_graph is not None:
            from ..parallel.distgraph import dist_take_rows

            p = plan.samp_size_p
            idx = jnp.concatenate([pos_src, pos_dst, neg_src, neg_dst])
            rows = dist_take_rows(dist_graph, h, idx)
            pos = edge_dot(rows[:p], rows[p: 2 * p])
            neg = edge_dot(rows[2 * p: 2 * p + n_neg], rows[2 * p + n_neg:])
        else:
            pos = edge_dot(h[pos_src], h[pos_dst])
            neg = edge_dot(h[neg_src], h[neg_dst])
        return linkp_loss_eva(pos, neg)

    return f
