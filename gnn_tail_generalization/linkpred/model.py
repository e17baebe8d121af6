"""Link-prediction model: input layer + encoder + predictor, jitted loops.

Reference parity: ``/root/reference/Link_prediction_model/model.py``
- input layer (268-288): raw feats / trainable node embedding / both
- encoder & predictor factories (290-319)
- train (121-169): full-graph encode per edge minibatch, pos/neg scores,
  configurable loss, per-module grad clip, Adam/AdamW
- batch_predict/test (171-266): full-split scoring + hits/mrr/recall

Edge minibatches are fixed-size (pad+mask); the encode runs once
per step under jit; negative sampling is the fixed-shape sampler of
linkpred/sampling.py.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from ..nn import module as nn
import jax
import jax.numpy as jnp
import optax

from ..graph.core import Graph, build_graph, symmetrize
from . import losses as L
from . import metrics as M
from . import sampling
from .encoders import GNNEncoder
from .predictors import create_predictor


@dataclass(frozen=True)
class LinkPredConfig:
    """Mirrors the BaseModel ctor args (model.py:43-88) + trainer flags."""

    encoder: str = "SAGE"
    predictor: str = "DOT"
    loss_func: str = "ce_loss"
    optimizer: str = "Adam"
    neg_sampler: str = "global"
    lr: float = 0.001
    dropout: float = 0.2
    grad_clip_norm: float = 2.0
    gnn_num_layers: int = 2
    mlp_num_layers: int = 2
    emb_hidden_channels: int = 256
    gnn_hidden_channels: int = 256
    mlp_hidden_channels: int = 256
    num_neg: int = 3
    batch_size: int = 64 * 1024
    use_node_feats: bool = False
    train_node_emb: bool = True
    eval_metric: str = "recall_my@1.25"
    edge_lp_mode: str = ""  # '' | 'logit' | 'emb' | 'xmc' (model.py:208-239)
    #: ops/spmm.SPMM_METHODS; 'bf16_operands' aggregates with bf16 operands
    #: and f32 accumulation; the default matches the reference's f32
    spmm_method: str = "gather"
    elp_alpha: float = 0.995
    elp_num_propagations: int = 5


class LinkPredModel(nn.Module):
    cfg: LinkPredConfig
    n_node: int
    num_node_feats: int

    def setup(self):
        c = self.cfg
        if c.train_node_emb or not c.use_node_feats:
            self.node_emb = self.param(
                "node_emb",
                nn.initializers.xavier_uniform(),
                (self.n_node, c.emb_hidden_channels),
            )
        else:
            self.node_emb = None
        self.encoder = GNNEncoder(
            kind=c.encoder,
            hidden_channels=c.gnn_hidden_channels,
            out_channels=c.gnn_hidden_channels,
            num_layers=c.gnn_num_layers,
            dropout=c.dropout,
            spmm_method=c.spmm_method,
        )
        self.predictor = create_predictor(
            c.predictor, c.mlp_hidden_channels, c.mlp_num_layers, c.dropout
        )

    def input_feat(self, x):
        """create_input_feat (model.py:96-106)."""
        c = self.cfg
        if c.use_node_feats:
            feats = x
            if self.node_emb is not None:
                feats = jnp.concatenate([self.node_emb, feats], axis=-1)
            return feats
        return self.node_emb

    def encode(self, g: Graph, x, *, train: bool = False, agg0=None):
        return self.encoder(g, self.input_feat(x), train=train, agg0=agg0)

    def predict(self, h, src, dst, *, train: bool = False):
        return self.predictor(h[src], h[dst], train=train)

    def predict_pairs(self, hs, hd, *, train: bool = False):
        """predict with the endpoint rows already gathered — the sharded
        trainer gathers them via dist_take_rows (one [B, d] psum) since
        GSPMD has no canonical sharding for a replicated-index gather
        from the row-sharded embedding table."""
        return self.predictor(hs, hd, train=train)

    def __call__(self, g: Graph, x, src, dst, *, train: bool = False):
        h = self.encode(g, x, train=train)
        return self.predict(h, src, dst, train=train)


def compute_loss(cfg: LinkPredConfig, pos_out, neg_out, margin=None,
                 valid=None):
    """calculate_loss (model.py:108-119). ``valid`` masks wrap-filled
    entries of the final partial batch (losses.py docstring)."""
    name = cfg.loss_func
    if name == "ce_loss":
        return L.ce_loss(pos_out, neg_out, valid=valid, num_neg=cfg.num_neg)
    if name == "info_nce_loss":
        return L.info_nce_loss(pos_out, neg_out, cfg.num_neg, valid=valid)
    if name == "log_rank_loss":
        return L.log_rank_loss(pos_out, neg_out, cfg.num_neg, valid=valid)
    if name == "adaptive_auc_loss" and margin is not None:
        return L.adaptive_auc_loss(pos_out, neg_out, cfg.num_neg, margin,
                                   valid=valid)
    return L.auc_loss(pos_out, neg_out, cfg.num_neg, valid=valid)


# ---------------------------------------------------------------------------
# Edge splits
# ---------------------------------------------------------------------------


def simple_split_edges(edge_index: np.ndarray, n_node: int,
                       val_frac: float = 0.05, test_frac: float = 0.1,
                       num_neg_eval: int = 100, seed: int = 0):
    """Random train/valid/test positive-edge split with sampled eval
    negatives (the random-split path of init_split_edge_unified_impl,
    utils.py:62-145; the transfer-setting masks are handled by the graph
    surgery utilities before this)."""
    rng = np.random.default_rng(seed)
    e = np.asarray(edge_index)
    # undirected: keep each pair once
    und = e[:, e[0] < e[1]]
    m = und.shape[1]
    perm = rng.permutation(m)
    n_val = int(m * val_frac)
    n_test = int(m * test_frac)
    val = und[:, perm[:n_val]]
    test = und[:, perm[n_val:n_val + n_test]]
    train = und[:, perm[n_val + n_test:]]

    keys = sampling.edge_keys(e, n_node)

    def sample_negs(count):
        return sampling.rejection_sample_non_edges(rng, keys, n_node, count)

    split_edge = {
        "train": {"edge": train.T},
        "valid": {"edge": val.T,
                  "edge_neg": sample_negs(max(n_val, 1) * num_neg_eval)},
        "test": {"edge": test.T,
                 "edge_neg": sample_negs(max(n_test, 1) * num_neg_eval)},
    }
    # message-passing graph = train positives symmetrized
    msg_edges = symmetrize(np.concatenate([train, train[::-1]], axis=1),
                           n_node)
    return split_edge, msg_edges


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


class Logger:
    """Per-run (valid, test) series; best-by-valid statistics
    (Link_prediction_model/logger.py:5-46)."""

    def __init__(self, runs: int):
        self.results = [[] for _ in range(runs)]

    def add_result(self, run: int, result):
        self.results[run].append(tuple(result))

    def best(self, run: int):
        arr = np.asarray(self.results[run])
        if len(arr) == 0:
            return (np.nan, np.nan)
        i = int(np.argmax(arr[:, 0]))
        return tuple(arr[i])

    def statistics(self):
        bests = np.asarray([self.best(r) for r in range(len(self.results))])
        return {
            "valid_mean": float(np.nanmean(bests[:, 0])),
            "valid_std": float(np.nanstd(bests[:, 0])),
            "test_mean": float(np.nanmean(bests[:, 1])),
            "test_std": float(np.nanstd(bests[:, 1])),
        }


def _plain_take(h, idx):
    return h[idx]


def make_loss_fn(cfg: LinkPredConfig, model: LinkPredModel,
                 take_rows=_plain_take):
    def loss_fn(params, c, pos_edge, neg_edge, rng, valid):
        h = model.apply(
            {"params": params}, c["g"], c["x"], train=True,
            rngs={"dropout": rng}, agg0=c.get("agg0"),
            method=model.encode,
        )
        pos_out = model.apply(
            {"params": params}, take_rows(h, pos_edge[:, 0]),
            take_rows(h, pos_edge[:, 1]),
            train=True, rngs={"dropout": jax.random.fold_in(rng, 1)},
            method=model.predict_pairs,
        )
        neg = neg_edge.reshape(-1, 2)
        neg_out = model.apply(
            {"params": params}, take_rows(h, neg[:, 0]),
            take_rows(h, neg[:, 1]),
            train=True, rngs={"dropout": jax.random.fold_in(rng, 2)},
            method=model.predict_pairs,
        )
        return compute_loss(cfg, pos_out, neg_out, valid=valid)

    return loss_fn


def make_train_step(cfg: LinkPredConfig, model: LinkPredModel, tx,
                    take_rows=_plain_take):
    loss_fn = make_loss_fn(cfg, model, take_rows)

    @jax.jit
    def step(params, opt_state, c, pos_edge, neg_edge, rng, valid):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, c, pos_edge, neg_edge, rng, valid
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_epoch_fn(cfg: LinkPredConfig, model: LinkPredModel, tx,
                  n_node: int, n_steps: int, bsz: int, n_draw: int,
                  take_rows=_plain_take):
    """ONE jitted program per epoch: device permutation of the positive
    table, per-step negative draws, and ``n_steps`` train steps under
    ``lax.scan`` — a single host round-trip per epoch instead of per
    minibatch.

    params/opt_state are donated, the carry holds nothing else, and the
    positive table stays device-resident across epochs — this is what
    lets the citation2-scale step fit HBM under scan (round-3's attempt
    carried per-step host batches and double-buffered state).

    Semantics vs the host loop: identical protocol (every positive
    visited once per epoch, wrap-filled final batch masked); negatives
    are drawn per step instead of per epoch and the permutation is
    jax.random instead of numpy — iid-equivalent, different streams."""
    loss_fn = make_loss_fn(cfg, model, take_rows)

    def epoch(params, opt_state, c, pos_all, keys_sorted, k_ep):
        perm = jax.random.permutation(
            jax.random.fold_in(k_ep, 0x7919), pos_all.shape[0])
        # negatives for the WHOLE epoch in one batched draw (the
        # reference also draws per epoch, utils.py:7-41): one membership
        # test of n_steps*bsz*num_neg candidates amortizes the hash-table
        # probe + spill search across the scan. The scan consumes
        # per-step slices as xs, so nothing rides the carry.
        k_neg = jax.random.fold_in(k_ep, 3)
        if cfg.neg_sampler == "global":
            neg_all = sampling.global_neg_sample(
                k_neg, keys_sorted, n_node, n_steps * bsz, cfg.num_neg)
        elif cfg.neg_sampler == "local":
            pos_seq = pos_all[perm[
                (jnp.arange(n_steps * bsz) % n_draw)]]
            neg_all = sampling.local_neg_sample(k_neg, pos_seq, n_node,
                                                cfg.num_neg)
        else:  # global_perm: permuted copies within each step's batch
            neg_all = sampling.global_perm_neg_sample(
                k_neg, keys_sorted, n_node, n_steps * bsz, cfg.num_neg,
                perm_within=bsz)
        neg_all = neg_all.reshape(n_steps, bsz, cfg.num_neg, 2)

        def body(carry, xs):
            params, opt_state = carry
            s, neg = xs
            k_s = jax.random.fold_in(k_ep, s)
            idx = s * bsz + jnp.arange(bsz)
            pos_i = idx % n_draw
            pos = pos_all[perm[pos_i]]
            valid = (idx < n_draw).astype(jnp.float32)
            loss, grads = jax.value_and_grad(loss_fn)(
                params, c, pos, neg, jax.random.fold_in(k_s, 1), valid)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), (jnp.arange(n_steps), neg_all))
        return params, opt_state, losses

    return jax.jit(epoch, donate_argnums=(0, 1))


def train_linkpred(
    cfg: LinkPredConfig,
    x: Optional[np.ndarray],
    edge_index: np.ndarray,
    n_node: int,
    epochs: int = 5,
    runs: int = 1,
    eval_steps: int = 1,
    seed: int = 0,
    log_every: int = 0,
    split_edge: Optional[Dict] = None,
    msg_edges: Optional[np.ndarray] = None,
    max_steps_per_epoch: Optional[int] = None,
    device_epoch: bool = True,
    mesh=None,
    dist_axis: str = "graph",
    dist_rb: int = 128,
) -> Dict[str, Any]:
    """The run x epoch loop of trainer_link_prediction.py:215-431. With
    ``split_edge`` given (e.g. from linkpred/surgery.py transfer settings)
    the provided split is used; otherwise a random split is made.
    ``max_steps_per_epoch`` caps minibatches per epoch (benchmarking at
    ogbl scale; None = the reference's full pass over positives).
    ``device_epoch=True`` (default) runs each epoch as ONE jitted
    scan-of-steps with device-side permutation and negative draws
    (make_epoch_fn); False keeps the per-batch host loop (reference-
    style pairing of per-epoch negatives with positive indices).
    ``mesh``: a jax Mesh with a ``dist_axis`` dimension shards the whole
    trainer — the message graph becomes a DistGraph (ring SpMM), features
    and the encoded table row-shard over the axis, and endpoint rows for
    the predictor ride dist_take_rows psums. Requires raw-feature input
    (no trainable node embedding) and a conv encoder."""
    if split_edge is None:
        split_edge, msg_edges = simple_split_edges(edge_index, n_node,
                                                   seed=seed)
    elif msg_edges is None:
        msg_edges = symmetrize(np.asarray(split_edge["train"]["edge"]).T,
                               n_node)
    if cfg.encoder in ("CN", "AA", "PPR"):
        # heuristic short-circuit (model.py:122-124,176-178): no training;
        # score every split with the heuristic on the message graph
        from . import heuristics as H

        def hscore(edges):
            return jnp.asarray(H.heuristic_scores(
                cfg.encoder, msg_edges, n_node,
                np.asarray(edges).T).astype(np.float32))

        pos_train = hscore(split_edge["train"]["edge"])
        pos_val = hscore(split_edge["valid"]["edge"])
        neg_val = hscore(split_edge["valid"]["edge_neg"])
        pos_test = hscore(split_edge["test"]["edge"])
        neg_test = hscore(split_edge["test"]["edge_neg"])
        m = cfg.eval_metric
        if m == "hits":
            results = M.evaluate_hits(pos_val, neg_val, pos_test, neg_test)
        elif m == "mrr":
            results = M.evaluate_mrr(pos_val, neg_val, pos_test, neg_test)
        else:
            topk = float(m.split("@")[1]) if "@" in m else None
            results = M.evaluate_recall_my(pos_train, neg_val, pos_val,
                                           neg_val, pos_test, neg_test,
                                           topk=topk)
        logger = Logger(1)
        vals = list(results.values())[0]
        logger.add_result(0, vals[-2:])
        return {"logger": logger, "stats": logger.statistics(),
                "last_results": results, "params": None,
                "split_edge": split_edge}

    e_msg, w_msg = msg_edges, None
    if cfg.encoder.upper() == "GCN":
        from ..graph.core import gcn_norm_weights, add_self_loops, \
            remove_self_loops

        e_msg = add_self_loops(remove_self_loops(msg_edges), n_node)
        w_msg = gcn_norm_weights(e_msg, n_node)

    take_rows = _plain_take
    if mesh is not None:
        from ..parallel.distgraph import (
            build_dist_graph, dist_take_rows, global_put, pad_rows_np,
        )
        from jax.sharding import NamedSharding, PartitionSpec as P

        assert cfg.use_node_feats and not cfg.train_node_emb, (
            "sharded linkpred runs on raw features (a trainable node "
            "embedding would need its own row sharding)")
        assert cfg.encoder.upper() not in ("TRANSFORMER", "MLP"), \
            cfg.encoder
        assert not cfg.edge_lp_mode, "edge-LP modes walk COO edge arrays"
        g = build_dist_graph(e_msg, n_node, mesh, edge_weight=w_msg,
                             axis=dist_axis, rb=dist_rb)
        xd = global_put(
            pad_rows_np(np.asarray(x, np.float32), g.n_node_pad),
            NamedSharding(mesh, P(dist_axis, None)))
        take_rows = lambda h, i: dist_take_rows(g, h, i)  # noqa: E731
        rep_sharding = NamedSharding(mesh, P())
    else:
        g = build_graph(e_msg, n_node, edge_weight=w_msg)
        xd = (jnp.zeros((n_node, 1)) if x is None
              else jnp.asarray(x, jnp.float32))

    num_feats = 0 if x is None else x.shape[1]
    model = LinkPredModel(cfg, n_node, num_feats)
    # layer-1 aggregation hoist: when the encoder input is CONSTANT under
    # training (raw features, no trainable embedding) the first conv's
    # SpMM is a loop invariant — compute it once instead of every step
    # (the reference full-graph-encodes per minibatch, model.py:144-152).
    # Saves one of the three per-step SpMMs (fwd L1; L1 has no backward
    # SpMM since its input carries no gradient). Stored bf16 on the
    # bf16_operands path: it only feeds bf16 dense matmuls there.
    from .encoders import hoistable, hoisted_first_agg

    agg0 = None
    if (cfg.use_node_feats and not cfg.train_node_emb
            and hoistable(cfg.encoder)):
        agg0 = jax.jit(
            lambda g_, x_: hoisted_first_agg(
                cfg.encoder, g_, x_, cfg.spmm_method
            ).astype(jnp.bfloat16 if cfg.spmm_method == "bf16_operands"
                     else jnp.float32)
        )(g, xd)
    const = {"g": g, "x": xd, "agg0": agg0}

    pos_train = np.asarray(split_edge["train"]["edge"])
    n_pos = pos_train.shape[0]
    bsz = min(cfg.batch_size, n_pos)
    keys_np = sampling.edge_keys(msg_edges, n_node)
    # large graphs: O(1) hash-bucket membership instead of searchsorted
    # (sampling.py)
    keys_sorted = (sampling.build_membership(keys_np)
                   if n_node > 100_000 else jnp.asarray(keys_np))

    n_draw_fix = n_pos
    if max_steps_per_epoch:
        n_draw_fix = min(n_pos, max_steps_per_epoch * bsz)
    n_steps = (n_draw_fix + bsz - 1) // bsz

    if cfg.optimizer == "AdamW":
        base = optax.adamw(cfg.lr)
    else:
        base = optax.adam(cfg.lr)
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm), base) \
        if cfg.grad_clip_norm >= 0 else base

    if device_epoch:
        epoch_fn = make_epoch_fn(cfg, model, tx, n_node, n_steps, bsz,
                                 n_draw_fix, take_rows)
        pos_all_dev = jnp.asarray(pos_train.astype(np.int32))
    else:
        step = make_train_step(cfg, model, tx, take_rows)

    @jax.jit
    def encode_all(params, c):
        return model.apply({"params": params}, c["g"], c["x"], train=False,
                           agg0=c.get("agg0"), method=model.encode)

    @jax.jit
    def predict_chunk(params, h, edges):
        return model.apply({"params": params}, take_rows(h, edges[:, 0]),
                           take_rows(h, edges[:, 1]),
                           train=False, method=model.predict_pairs)

    def predict_chunked(params, h, edges, chunk: int = 64 * 1024):
        """batch_predict (model.py:172-185): fixed-size chunks so one
        program serves every split; the encode runs ONCE per evaluation
        (reference encodes once in test(), model.py:187) — at ogbl scale a
        whole-split gather would materialize [E, d] tens-of-GB
        intermediates and re-encode per split."""
        edges = np.asarray(edges)
        m = len(edges)
        if m <= chunk:
            return predict_chunk(params, h, jnp.asarray(edges))
        outs = []
        for s0 in range(0, m, chunk):
            idx = (s0 + np.arange(chunk)) % m  # wrap-pad: one static shape
            outs.append(predict_chunk(params, h, jnp.asarray(edges[idx])))
        return jnp.concatenate(outs)[:m]

    logger = Logger(runs)
    root = jax.random.PRNGKey(seed)
    results_last = None

    def _init_fwd(mdl, g_, x_):
        # exercises encoder AND predictor without an embedding-table
        # gather (which has no canonical GSPMD sharding when h is
        # row-sharded); parameter shapes/values identical to __call__ init
        h = mdl.encode(g_, x_)
        probe = jnp.zeros((2, h.shape[-1]), h.dtype)
        return mdl.predict_pairs(probe, probe)

    for run in range(runs):
        k_run = jax.random.fold_in(root, run)
        params = jax.jit(
            lambda c: model.init(
                {"params": jax.random.fold_in(k_run, 999),
                 "dropout": k_run},
                c["g"], c["x"], method=_init_fwd,
            )
        )(const)["params"]
        if mesh is not None:
            # commit params replicated: under explicitly-typed mesh axes
            # an uncommitted param makes dW = x^T dh (contraction over the
            # row-sharded dim) ambiguous to the sharding type system
            params = jax.device_put(params, rep_sharding)
        opt_state = tx.init(params)

        for epoch in range(epochs):
            k_ep = jax.random.fold_in(k_run, epoch)
            if device_epoch:
                # one program, one host sync per epoch (make_epoch_fn)
                params, opt_state, losses_dev = epoch_fn(
                    params, opt_state, const, pos_all_dev, keys_sorted,
                    k_ep)
                nb = n_steps
                total_loss = float(jnp.sum(losses_dev))
                if (epoch + 1) % eval_steps == 0:
                    results = evaluate(cfg, model, params, const,
                                       split_edge, encode_all,
                                       predict_chunked)
                    key = list(results.keys())[0]
                    vals = results[key]
                    logger.add_result(run, vals[-2:])
                    results_last = results
                    if log_every:
                        print(f"run {run} ep {epoch}: "
                              f"loss={total_loss/max(nb,1):.4f} "
                              f"{key}={vals}")
                continue
            perm = np.random.default_rng(seed * 1000 + epoch).permutation(
                n_pos)
            # capped epochs (benchmarking): only draw negatives for the
            # positives actually visited — negatives then pair with batch
            # POSITIONS (perm prefix) instead of positive indices, which
            # is distributionally identical for the iid samplers
            n_draw = n_pos
            if max_steps_per_epoch:
                n_draw = min(n_pos, max_steps_per_epoch * bsz)
                perm = perm[:n_draw]
            pos_for_local = pos_train if n_draw == n_pos else \
                pos_train[perm]
            if cfg.neg_sampler == "global":
                neg = sampling.global_neg_sample(
                    k_ep, keys_sorted, n_node, n_draw, cfg.num_neg)
            elif cfg.neg_sampler == "local":
                neg = sampling.local_neg_sample(
                    k_ep, jnp.asarray(pos_for_local), n_node, cfg.num_neg)
            else:
                neg = sampling.global_perm_neg_sample(
                    k_ep, keys_sorted, n_node, n_draw, cfg.num_neg)

            losses = []
            # every positive edge is visited each epoch: the final partial
            # batch is wrap-filled from the permutation's start so the step
            # keeps one static shape, but the wrapped entries' loss is
            # masked to zero — matching the reference's drop_last=False
            # partial batch (model.py:144), which never duplicates edges.
            # Loss values are read back ONCE per epoch: a per-batch
            # float(loss) forces a host sync per step, which serializes
            # dispatch against execution.
            for s0 in range(0, n_draw, bsz):
                idx = s0 + np.arange(bsz)
                pos_i = idx % n_draw
                sel = perm[pos_i]
                # uncapped: negatives are per-positive (neg[sel], the
                # original pairing); capped: per-position (neg[pos_i])
                nsel = sel if n_draw == n_pos else pos_i
                valid = jnp.asarray((idx < n_draw).astype(np.float32))
                params, opt_state, loss = step(
                    params, opt_state, const,
                    jnp.asarray(pos_train[sel]), neg[nsel],
                    jax.random.fold_in(k_ep, s0), valid,
                )
                losses.append(loss)
            nb = len(losses)
            total_loss = (float(jnp.sum(jnp.stack(losses)))  # ONE sync
                          if losses else 0.0)

            if (epoch + 1) % eval_steps == 0:
                results = evaluate(cfg, model, params, const, split_edge,
                                   encode_all, predict_chunked)
                key = list(results.keys())[0]
                vals = results[key]
                logger.add_result(run, vals[-2:])
                results_last = results
                if log_every:
                    print(f"run {run} ep {epoch}: loss={total_loss/max(nb,1):.4f} "
                          f"{key}={vals}")

    return {"logger": logger, "stats": logger.statistics(),
            "last_results": results_last, "params": params,
            "split_edge": split_edge}


def evaluate(cfg, model, params, const, split_edge, encode_all,
             predict_chunked):
    """model.test (model.py:187-266) incl. the optional edge-level LP
    post-processing (208-239). Encodes ONCE, scores each split in
    fixed-size chunks."""
    h_eval = encode_all(params, const)

    def scores(edges):
        return predict_chunked(params, h_eval, np.asarray(edges))

    pos_val = scores(split_edge["valid"]["edge"])
    neg_val = scores(split_edge["valid"]["edge_neg"])
    pos_test = scores(split_edge["test"]["edge"])
    neg_test = scores(split_edge["test"]["edge_neg"])
    # train positives are consumed only by recall_my and the edge-LP
    # guidance — at citation2 scale they are ~15M edges, half of every
    # evaluation if scored unconditionally
    need_train = (cfg.eval_metric.startswith("recall_my")
                  or cfg.edge_lp_mode in ("logit", "xmc", "emb"))
    pos_train = (scores(split_edge["train"]["edge"]) if need_train
                 else jnp.zeros((0,)))
    neg_train = neg_val  # reference uses fresh global negs; reuse eval negs

    if cfg.edge_lp_mode in ("logit", "xmc", "emb"):
        from . import edge_lp as elp

        # logits order [pos_train, pos_valid, pos_test, negs...] — the
        # guidance layout of run_logitLP (edge_LP.py:59-64)
        all_edges = np.concatenate(
            [np.asarray(split_edge["train"]["edge"]),
             np.asarray(split_edge["valid"]["edge"]),
             np.asarray(split_edge["test"]["edge"]),
             np.asarray(split_edge["valid"]["edge_neg"]),
             np.asarray(split_edge["test"]["edge_neg"])], axis=0,
        )
        sizes = [len(pos_train), len(pos_val), len(pos_test),
                 len(neg_val), len(neg_test)]
        n_pos_total = sizes[0] + sizes[1] + sizes[2]
        if cfg.edge_lp_mode == "emb":
            out = elp.run_emb_lp(all_edges, h_eval, cfg.elp_alpha,
                                 cfg.elp_num_propagations)
        else:
            logits = jnp.concatenate(
                [pos_train, pos_val, pos_test, neg_val, neg_test])
            if cfg.edge_lp_mode == "logit":
                out = elp.run_logit_lp(all_edges, logits, sizes[0],
                                       n_pos_total, cfg.elp_alpha,
                                       cfg.elp_num_propagations)
            else:
                n = const["g"].n_node
                # slice off the static-shape PADDING edges (last-node
                # self-loops with weight 0): run_xmc_lp rebuilds a D^-1 A
                # from the raw edge list, where padding would become real
                # weighted self-loops at the last node
                ne = const["g"].n_edge
                e_msg = np.stack([np.asarray(const["g"].senders)[:ne],
                                  np.asarray(const["g"].receivers)[:ne]])
                out = elp.run_xmc_lp(e_msg, n, all_edges, logits,
                                     sizes[0], n_pos_total,
                                     cfg.elp_alpha,
                                     cfg.elp_num_propagations)
        ofs = np.cumsum([0] + sizes)
        pos_train = out[ofs[0]:ofs[1]]
        pos_val = out[ofs[1]:ofs[2]]
        pos_test = out[ofs[2]:ofs[3]]
        neg_val = out[ofs[3]:ofs[4]]
        neg_test = out[ofs[4]:ofs[5]]
        neg_train = neg_val

    m = cfg.eval_metric
    if m == "hits":
        return M.evaluate_hits(pos_val, neg_val, pos_test, neg_test)
    if m == "mrr":
        return M.evaluate_mrr(pos_val, neg_val, pos_test, neg_test)
    if "recall_my" in m:
        topk = float(m.split("@")[1])
        return M.evaluate_recall_my(pos_train, neg_train, pos_val, neg_val,
                                    pos_test, neg_test, topk=topk)
    raise ValueError(m)
