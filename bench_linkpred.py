"""Link prediction at ogbl-citation2 scale on the accelerator.

The reference's I2_GTL headline dataset is ogbl-citation2 (2.9M nodes,
~30M directed edges, /root/reference/trainer_link_prediction.py:215-431);
protocol = full-graph encode per 64Ki-edge minibatch
(/root/reference/Link_prediction_model/model.py:144-152).

This script:
1. trains SAGE+DOT through train_linkpred (library path) on a synthetic
   citation2-shaped graph — finiteness + MRR + cold/warm wall-clock, with
   the device-resident scanned epoch (ONE host sync per epoch);
2. times the scanned train step directly (best of 4 epochs);
3. runs the fixed-1000-negative OGB evaluation;
4. prints ONE JSON line, with the device it ran on.

Step anatomy (SAGE 2-layer, raw-feature input): layer-1 aggregation is
HOISTED (constant input -> loop invariant; encoders.py hoisted_first_agg),
so the step runs 2 SpMMs (fwd layer-2 + its transposed backward) with
bf16 operands, a bf16 dense tail, halfword dropout.
"""
import json
import sys
import time

import numpy as np

_T0 = time.time()


def _log(*a):
    print(f"[lp {time.time()-_T0:6.1f}s]", *a, file=sys.stderr, flush=True)


def citation2_split(n_node, n_edge, eval_pos=8192, num_neg_eval=50,
                    seed=0):
    """A synthetic ogbl-citation2-shaped split: ``n_edge`` power-law edges,
    ``eval_pos`` valid and test positives with ``num_neg_eval`` uniform
    non-edge negatives each, the rest train; the message graph is the
    symmetrized train set. Returns (all edges, split_edge, msg_edges)."""
    from gnn_tail_generalization.data.synthetic import (
        fast_powerlaw_graph,
    )
    from gnn_tail_generalization.graph.core import symmetrize
    from gnn_tail_generalization.linkpred import sampling

    rng = np.random.default_rng(seed)
    e = fast_powerlaw_graph(n_node, n_edge, seed)
    # most edges train, sampled eval sets (the real protocol's 86M eval
    # negatives would be pure host-build time on a synthetic benchmark;
    # the sampled-negative MRR protocol is labeled in the JSON)
    perm = rng.permutation(e.shape[1])
    val = e[:, perm[:eval_pos]]
    test = e[:, perm[eval_pos: 2 * eval_pos]]
    train = e[:, perm[2 * eval_pos:]]
    keys = sampling.edge_keys(e, n_node)
    negs = np.asarray(sampling.rejection_sample_non_edges(
        np.random.default_rng(seed + 1), keys, n_node,
        2 * eval_pos * num_neg_eval))
    split_edge = {
        "train": {"edge": train.T},
        "valid": {"edge": val.T,
                  "edge_neg": negs[: eval_pos * num_neg_eval]},
        "test": {"edge": test.T,
                 "edge_neg": negs[eval_pos * num_neg_eval:]},
    }
    return e, split_edge, symmetrize(train, n_node)


def main(n_node=2_927_963, n_edge=30_387_995 // 2, n_feat=128,
         eval_pos=8192, num_neg_eval=50, seed=0):
    from gnn_tail_generalization.linkpred import sampling
    from gnn_tail_generalization.linkpred.model import (
        LinkPredConfig, train_linkpred,
    )

    import jax
    import jax.numpy as jnp

    from gnn_tail_generalization.utils.device import device_fields

    rng = np.random.default_rng(seed)
    e, split_edge, msg_edges = citation2_split(n_node, n_edge, eval_pos,
                                               num_neg_eval, seed)
    train = split_edge["train"]["edge"].T
    val = split_edge["valid"]["edge"].T
    _log(f"split built: train={train.shape[1]} msg={msg_edges.shape[1]}")
    # features generated ON the device: a [2.9M, 128] f32 table is 1.5 GB
    # of host-to-device transfer if built host-side
    x = jax.jit(lambda k: jax.random.normal(k, (n_node, n_feat)),
                )(jax.random.PRNGKey(seed))
    _log("features built (on device)")

    cfg = LinkPredConfig(
        encoder="SAGE", predictor="DOT", loss_func="ce_loss",
        use_node_feats=True, train_node_emb=False,
        eval_metric="mrr", num_neg=3, batch_size=64 * 1024,
        spmm_method="bf16_operands",
    )

    t0 = time.time()
    out = train_linkpred(
        cfg, x, e, n_node, epochs=2, runs=1, eval_steps=2, seed=seed,
        split_edge=split_edge, msg_edges=msg_edges,
        max_steps_per_epoch=8, log_every=1,
    )
    wall = time.time() - t0
    stats = out["stats"]
    _log(f"done: {stats} wall={wall:.1f}s")
    mrr_test = stats["test_mean"]
    assert np.isfinite(mrr_test)
    del out

    # --- direct step timing: the same library pieces train_linkpred uses,
    # assembled once so repeat timings don't pay the host graph build
    from gnn_tail_generalization.graph.core import build_graph
    from gnn_tail_generalization.linkpred.encoders import (
        hoisted_first_agg,
    )
    from gnn_tail_generalization.linkpred.model import (
        LinkPredModel, make_epoch_fn,
    )
    import optax

    g = build_graph(msg_edges, n_node)
    agg0 = jax.jit(
        lambda g_, x_: hoisted_first_agg("SAGE", g_, x_, cfg.spmm_method)
        .astype(jnp.bfloat16))(g, x)
    const = {"g": g, "x": x, "agg0": agg0}
    model = LinkPredModel(cfg, n_node, n_feat)
    k = jax.random.PRNGKey(seed)
    params = jax.jit(
        lambda c: model.init(
            {"params": k, "dropout": k}, c["g"], c["x"],
            jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.int32), train=False,
        ))(const)["params"]
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm),
                     optax.adam(cfg.lr))
    opt_state = tx.init(params)
    n_steps = 16
    bsz = cfg.batch_size
    epoch_fn = make_epoch_fn(cfg, model, tx, n_node, n_steps, bsz,
                             n_steps * bsz)
    pos_all = jnp.asarray(train.T[: n_steps * bsz].astype(np.int32))
    keys_sorted = sampling.build_membership(
        sampling.edge_keys(msg_edges, n_node))

    params, opt_state, losses = epoch_fn(
        params, opt_state, const, pos_all, keys_sorted, k)  # compile+warm
    float(jnp.sum(losses))
    step_ms = float("inf")
    warm_epoch = float("inf")
    for w in range(2):
        t0 = time.perf_counter()
        params, opt_state, l1 = epoch_fn(
            params, opt_state, const, pos_all, keys_sorted,
            jax.random.fold_in(k, w + 1))
        float(jnp.sum(l1))
        warm_epoch = min(warm_epoch, time.perf_counter() - t0)
        t0 = time.perf_counter()
        params, opt_state, l2 = epoch_fn(
            params, opt_state, const, pos_all, keys_sorted,
            jax.random.fold_in(k, w + 10))
        float(jnp.sum(l2))
        warm_epoch = min(warm_epoch, time.perf_counter() - t0)
        step_ms = min(step_ms, warm_epoch / n_steps * 1e3)
    _log(f"scanned step: {step_ms:.0f} ms; warm {n_steps}-step epoch "
         f"(ONE dispatch+sync): {warm_epoch:.1f}s")

    # --- the REAL OGB citation2 eval protocol at scale (VERDICT r4 next
    # #6): fixed 1000-negative lists per positive
    # (/root/reference/Link_prediction_model/utils.py:43-91,
    # trainer_link_prediction.py:230-236) — encode once, score
    # [8192, 1000] negative destinations through the chunked predictor,
    # grouped MRR. OGB's lists are uniform random destinations (possible
    # collisions with true edges included), built per source node.
    from gnn_tail_generalization.linkpred import metrics as M

    n_eval_pos, n_neg_list = eval_pos, 1000
    pos_eval = val.T[:n_eval_pos].astype(np.int64)
    neg_dst = rng.integers(0, n_node, (n_eval_pos, n_neg_list))
    neg_edges = np.stack(
        [np.repeat(pos_eval[:, 0], n_neg_list), neg_dst.reshape(-1)],
        axis=1)

    @jax.jit
    def encode_all_fn(params, c):
        return model.apply({"params": params}, c["g"], c["x"], train=False,
                           agg0=c["agg0"], method=model.encode)

    @jax.jit
    def predict_chunk(params, h, edges):
        return model.apply({"params": params}, h[edges[:, 0]],
                           h[edges[:, 1]], train=False,
                           method=model.predict_pairs)

    def ogb_eval():
        h = encode_all_fn(params, const)
        chunk = 512 * 1024
        outs = [predict_chunk(params, h, jnp.asarray(pos_eval))]
        m = len(neg_edges)
        for s0 in range(0, m, chunk):
            idx = (s0 + np.arange(chunk)) % m
            outs.append(predict_chunk(params, h, jnp.asarray(
                neg_edges[idx])))
        pos_s = np.asarray(outs[0])
        neg_s = np.concatenate([np.asarray(o) for o in outs[1:]])[:m]
        return pos_s, neg_s.reshape(n_eval_pos, n_neg_list)

    pos_s, neg_s = ogb_eval()  # compile + warm
    t0 = time.perf_counter()
    pos_s, neg_s = ogb_eval()
    mrr_1000 = M.mrr(jnp.asarray(pos_s), jnp.asarray(neg_s))
    ogb_eval_s = time.perf_counter() - t0
    _log(f"OGB 1000-neg eval: {n_eval_pos} pos x {n_neg_list} negs in "
         f"{ogb_eval_s:.2f}s (warm, incl. full-graph encode), "
         f"MRR={mrr_1000:.4f}")
    assert np.isfinite(mrr_1000)
    del params, opt_state, const, agg0

    rec = {
        "metric": "linkpred_citation2_scale",
        "n_node": n_node,
        "n_msg_edges": int(msg_edges.shape[1]),
        "train_positives": int(train.shape[1]),
        "encoder": "SAGE", "predictor": "DOT",
        "mrr_test": round(float(mrr_test), 4),
        "eval_protocol": f"MRR over {num_neg_eval} sampled uniform "
                         "negatives per positive (train-loop eval); the "
                         "fixed-1000-negative OGB protocol is timed "
                         "separately below",
        "ogb_1000neg_eval": {
            "n_pos": n_eval_pos, "n_neg_per_pos": n_neg_list,
            "mrr": round(float(mrr_1000), 4),
            "warm_eval_s": round(ogb_eval_s, 2),
            "definition": "full-graph encode + chunked predict of "
                          "[8192 pos + 8192x1000 neg] pairs, grouped "
                          "MRR (utils.py:43-91 protocol)",
        },
        "wall_s_2epochs_8steps_cold": round(wall, 1),
        "warm_epoch_steps": n_steps,
        "warm_epoch_s": round(warm_epoch, 2),
        "step_ms": round(step_ms, 1),
        "step_definition": "train fwd+bwd+adam, 64Ki-edge batch, "
                           "full-graph encode; step_ms = (scanned "
                           "16-step epoch incl. ONE dispatch+sync) / 16, "
                           "best of 4 epochs; layer-1 agg hoisted "
                           "(2 SpMMs/step)",
        "spmm_method": cfg.spmm_method,
        **device_fields(),
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
