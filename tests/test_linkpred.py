"""Link-prediction stack: samplers, losses, metrics, encoders, end-to-end."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gnn_tail_generalization.graph import core
from gnn_tail_generalization.linkpred import (
    losses, metrics, model as lpm, sampling,
)
from gnn_tail_generalization.linkpred.encoders import GNNEncoder


def ring_graph(n=50):
    src = np.arange(n)
    dst = (src + 1) % n
    return core.symmetrize(np.stack([src, dst]), n)


def test_global_neg_sample_avoids_edges(rng):
    n = 30
    e = ring_graph(n)
    keys = jnp.asarray(sampling.edge_keys(e, n))
    neg = sampling.global_neg_sample(jax.random.PRNGKey(0), keys, n, 64, 3)
    assert neg.shape == (64, 3, 2)
    neg2 = np.asarray(neg).reshape(-1, 2)
    ek = set(np.asarray(sampling.edge_keys(e, n)).tolist())
    bad = sum(1 for s, d in neg2 if s * n + d in ek)
    assert bad <= 2  # fixed-rounds resampling: collisions vanishingly rare


def test_local_neg_sample_shape():
    pos = jnp.asarray(np.stack([np.arange(10), np.arange(10) + 1], axis=1))
    neg = sampling.local_neg_sample(jax.random.PRNGKey(0), pos, 30, 4)
    assert neg.shape == (10, 4, 2)
    np.testing.assert_array_equal(
        np.asarray(neg[:, :, 0]), np.tile(np.arange(10)[:, None], (1, 4))
    )


def test_losses_match_formulas(rng):
    pos = jnp.asarray(rng.normal(size=12).astype(np.float32))
    neg = jnp.asarray(rng.normal(size=36).astype(np.float32))
    auc = float(losses.auc_loss(pos, neg, 3))
    expect = np.square(
        1 - (np.asarray(pos).reshape(-1, 1) - np.asarray(neg).reshape(-1, 3))
    ).sum()
    np.testing.assert_allclose(auc, expect, rtol=1e-5)
    ce = float(losses.ce_loss(pos, neg))
    sig = lambda v: 1 / (1 + np.exp(-np.asarray(v)))
    expect = -np.log(sig(pos) + 1e-15).mean() - np.log(1 - sig(neg) + 1e-15).mean()
    np.testing.assert_allclose(ce, expect, rtol=1e-5)


def test_hits_and_mrr():
    pos = jnp.asarray([5.0, 3.0, 1.0])
    neg = jnp.asarray([4.0, 2.0, 0.0, -1.0])
    # hits@2: threshold = 2.0 -> pos > 2 are {5, 3} -> 2/3
    np.testing.assert_allclose(metrics.hits_at_k(pos, neg, 2), 2 / 3, rtol=1e-6)
    # mrr with per-pos negs
    negs = jnp.asarray([[4.0, 2.0], [4.0, 2.0], [4.0, 2.0]])
    # ranks: pos=5 -> 1; pos=3 -> 2; pos=1 -> 3
    np.testing.assert_allclose(
        metrics.mrr(pos, negs), np.mean([1, 1 / 2, 1 / 3]), rtol=1e-6
    )


def test_recall_topk():
    pos = jnp.asarray([3.0, 2.0, -1.0])
    neg = jnp.asarray([2.5, 1.0, 0.5])
    # topk None -> threshold-0 mode: 2 of 3 positives > 0
    np.testing.assert_allclose(metrics.cal_recall(pos, neg), 2 / 3, rtol=1e-6)
    # relative k = 1.0 * 3 = 3: negatives+filtered positives sorted:
    # [3, 2.5, 2, 1, 0.5]; top3 holds 2 positives / 3 total positives
    np.testing.assert_allclose(metrics.cal_recall(pos, neg, 1.0), 2 / 3,
                               rtol=1e-6)
    # absolute k = 6 (>5): everything within top-6 -> 2 (filtered) / 3
    np.testing.assert_allclose(metrics.cal_recall(pos, neg, 6), 2 / 3,
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["MLP", "SAGE", "GCN", "WSAGE", "Transformer"])
def test_encoders_run(rng, kind):
    n = 40
    e = ring_graph(n)
    g = core.build_graph(e, n)
    x = jnp.asarray(rng.normal(size=(n, 8)).astype(np.float32))
    enc = GNNEncoder(kind=kind, hidden_channels=16, out_channels=16,
                     num_layers=2, dropout=0.1)
    vs = enc.init({"params": jax.random.PRNGKey(0)}, g, x, train=False)
    h = enc.apply(vs, g, x, train=False)
    assert h.shape == (n, 16)
    assert np.isfinite(np.asarray(h)).all()


def test_transformer_attention_sums_to_one(rng):
    n = 20
    e = ring_graph(n)
    g = core.build_graph(e, n)
    # attention output of constant v should equal v itself + skip
    from gnn_tail_generalization.linkpred.encoders import TransformerConv

    x = jnp.asarray(rng.normal(size=(n, 8)).astype(np.float32))
    conv = TransformerConv(out_channels=8)
    vs = conv.init(jax.random.PRNGKey(0), g, x)
    h = conv.apply(vs, g, x)
    assert np.isfinite(np.asarray(h)).all()


def test_linkpred_end_to_end(rng):
    n = 60
    # two communities with dense intra-links
    a = rng.integers(0, 30, 300)
    b = rng.integers(0, 30, 300)
    e = np.concatenate(
        [np.stack([a, b]), np.stack([a + 30, b + 30])], axis=1
    )
    e = core.remove_self_loops(core.symmetrize(e, n))
    cfg = lpm.LinkPredConfig(encoder="SAGE", predictor="DOT",
                             loss_func="ce_loss", batch_size=128,
                             num_neg=2, eval_metric="hits")
    out = lpm.train_linkpred(cfg, None, e, n, epochs=3, runs=1,
                             seed=0)
    assert "Hits@20" in out["last_results"]
    stats = out["stats"]
    assert np.isfinite(stats["test_mean"])


def test_linkpred_mlp_encoder_with_feats(rng):
    n = 40
    e = ring_graph(n)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    cfg = lpm.LinkPredConfig(encoder="MLP", predictor="MLP",
                             use_node_feats=True, train_node_emb=False,
                             batch_size=64, num_neg=2, eval_metric="mrr")
    out = lpm.train_linkpred(cfg, x, e, n, epochs=2, runs=1)
    assert "MRR" in out["last_results"]


def test_heuristic_encoder_short_circuit(rng):
    n = 50
    e = core.remove_self_loops(core.symmetrize(
        np.stack([rng.integers(0, n, 300), rng.integers(0, n, 300)]), n))
    for enc in ["CN", "AA"]:
        cfg = lpm.LinkPredConfig(encoder=enc, eval_metric="hits")
        out = lpm.train_linkpred(cfg, None, e, n, epochs=1, runs=1)
        assert "Hits@20" in out["last_results"], enc
        assert out["params"] is None  # no training happened


def test_linkpred_bf16_aggregation_trains(rng):
    """spmm_method='bf16_operands' threads through the encoder stack;
    small run stays finite and produces sane stats."""
    import dataclasses

    from gnn_tail_generalization.linkpred import model as lpm

    n = 120
    e = np.stack([rng.integers(0, n, 700), rng.integers(0, n, 700)])
    x = rng.normal(size=(n, 16)).astype(np.float32)
    cfg = lpm.LinkPredConfig(encoder="SAGE", use_node_feats=True,
                             train_node_emb=False, batch_size=256,
                             spmm_method="bf16_operands")
    out = lpm.train_linkpred(cfg, x, e, n, epochs=3, runs=1, eval_steps=3)
    s = out["stats"]
    assert np.isfinite(s["test_mean"])


def test_losses_valid_mask_matches_true_partial_batch():
    """valid= masking must equal computing the loss on the true (smaller)
    batch (losses.py)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    n, num_neg, n_real = 16, 3, 11
    pos = jnp.asarray(rng.normal(size=(n,)).astype(np.float32))
    neg = jnp.asarray(rng.normal(size=(n * num_neg,)).astype(np.float32))
    valid = jnp.asarray((np.arange(n) < n_real).astype(np.float32))
    negm = neg.reshape(n, num_neg)[:n_real].reshape(-1)
    for name, fn in [
        ("auc", lambda p, ng, v=None: losses.auc_loss(p, ng, num_neg, v)),
        ("lr", lambda p, ng, v=None: losses.log_rank_loss(p, ng, num_neg, v)),
        ("nce", lambda p, ng, v=None: losses.info_nce_loss(p, ng, num_neg, v)),
        ("ce", lambda p, ng, v=None: losses.ce_loss(p, ng, v, num_neg)),
    ]:
        masked = float(fn(pos, neg, valid))
        true = float(fn(pos[:n_real], negm))
        assert np.isclose(masked, true, rtol=1e-5), (name, masked, true)


def test_predict_chunked_matches_whole():
    """batch_predict chunking (model.py:172-185 parity): chunked scoring
    must equal one-shot scoring."""
    rng = np.random.default_rng(4)
    n = 80
    e = rng.integers(0, n, (2, 300))
    x = rng.normal(size=(n, 8)).astype(np.float32)
    cfg = lpm.LinkPredConfig(encoder="SAGE", predictor="DOT",
                             batch_size=64)
    out = lpm.train_linkpred(cfg, x, e, n, epochs=1, runs=1)
    params = out["params"]
    model = lpm.LinkPredModel(cfg, n, 8)
    from gnn_tail_generalization.graph.core import symmetrize
    g = core.build_graph(
        symmetrize(np.asarray(out["split_edge"]["train"]["edge"]).T, n), n)
    const = {"g": g, "x": jnp.asarray(x)}
    h = model.apply({"params": params}, const["g"], const["x"],
                    train=False, method=model.encode)
    edges = np.asarray(out["split_edge"]["valid"]["edge_neg"])[:50]

    def predict(es):
        return model.apply({"params": params}, h, jnp.asarray(es[:, 0]),
                           jnp.asarray(es[:, 1]), train=False,
                           method=model.predict)

    whole = np.asarray(predict(edges))
    # chunked with wrap-pad, chunk smaller than the set
    chunk = 16
    outs = []
    for s0 in range(0, len(edges), chunk):
        idx = (s0 + np.arange(chunk)) % len(edges)
        outs.append(np.asarray(predict(edges[idx])))
    chunked = np.concatenate(outs)[: len(edges)]
    np.testing.assert_allclose(chunked, whole, rtol=1e-6)


def test_losses_finite_under_jit_at_saturation():
    """log(sigmoid(x)+eps) naively goes inf under XLA's fused lowering
    once |score| reaches a few hundred (routine for DOT predictors at
    ogbl scale — found by the citation2 bench); the stable logaddexp
    forms must stay finite AND match the naive math at moderate scores."""
    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.normal(size=64).astype(np.float32) * 3)
    neg = jnp.asarray(rng.normal(size=64 * 3).astype(np.float32) * 3)
    from jax.nn import sigmoid
    naive_ce = float(-jnp.mean(jnp.log(sigmoid(pos) + 1e-15))
                     - jnp.mean(jnp.log(1 - sigmoid(neg) + 1e-15)))
    assert np.isclose(float(losses.ce_loss(pos, neg)), naive_ce, rtol=1e-5)
    negm = neg.reshape(64, 3)
    naive_lr = float(-jnp.mean(jnp.log(sigmoid(pos[:, None] - negm) + 1e-15)))
    assert np.isclose(float(losses.log_rank_loss(pos, neg, 3)), naive_lr,
                      rtol=1e-5)
    pe = jnp.exp(pos[:, None])
    ne = jnp.sum(jnp.exp(negm), axis=1, keepdims=True)
    naive_nce = float(-jnp.mean(jnp.log(pe / (pe + ne) + 1e-15)))
    assert np.isclose(float(losses.info_nce_loss(pos, neg, 3)), naive_nce,
                      rtol=1e-5)
    for fn in (lambda: losses.ce_loss(pos * 200, neg * 200),
               lambda: losses.log_rank_loss(pos * 200, neg * 200, 3),
               lambda: losses.info_nce_loss(pos * 200, neg * 200, 3)):
        assert np.isfinite(float(jax.jit(fn)()))


# --- round 4: layer-1 aggregation hoist + scanned device epoch -----------


@pytest.mark.parametrize("kind", ["SAGE", "WSAGE", "GCN"])
def test_hoisted_first_agg_matches_unhoisted_encode(rng, kind):
    """encode(agg0=hoisted_first_agg(...)) == encode() — the hoist is pure
    CSE for SAGE/WSAGE (identical ops); GCN reassociates A@(xW) to (A@x)W
    (exact in math, equal to f32 tolerance)."""
    from gnn_tail_generalization.linkpred.encoders import (
        hoistable, hoisted_first_agg,
    )

    assert hoistable(kind)
    n = 80
    e = ring_graph(n)
    g = core.build_graph(e, n)
    x = jnp.asarray(rng.normal(size=(n, 16)).astype(np.float32))
    enc = GNNEncoder(kind=kind, hidden_channels=24, out_channels=8,
                     num_layers=2)
    params = enc.init(jax.random.PRNGKey(0), g, x)["params"]
    h_plain = enc.apply({"params": params}, g, x)
    agg0 = hoisted_first_agg(kind, g, x)
    h_hoist = enc.apply({"params": params}, g, x, agg0=agg0)
    rtol = 0 if kind in ("SAGE", "WSAGE") else 1e-5
    np.testing.assert_allclose(np.asarray(h_hoist), np.asarray(h_plain),
                               rtol=rtol, atol=1e-5 if rtol else 0)


def test_device_epoch_trains_and_is_deterministic(rng):
    """The scanned epoch path (make_epoch_fn): same seed -> identical
    stats; loss decreases over epochs; works with the hoist active."""
    n, m = 300, 2000
    e = np.unique(rng.integers(0, n, (2, m)), axis=1)
    e = e[:, e[0] != e[1]]
    x = rng.normal(size=(n, 16)).astype(np.float32)
    cfg = lpm.LinkPredConfig(encoder="SAGE", predictor="DOT",
                             use_node_feats=True, train_node_emb=False,
                             eval_metric="mrr", batch_size=128)
    out1 = lpm.train_linkpred(cfg, x, e, n, epochs=2, runs=1, seed=3)
    out2 = lpm.train_linkpred(cfg, x, e, n, epochs=2, runs=1, seed=3)
    assert out1["stats"] == out2["stats"]
    assert np.isfinite(out1["stats"]["test_mean"])
    leaves1 = jax.tree.leaves(out1["params"])
    leaves2 = jax.tree.leaves(out2["params"])
    for a, b in zip(leaves1, leaves2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_device_epoch_wrap_mask_partial_batch(rng):
    """n_pos not a multiple of batch_size: the scanned path wrap-fills the
    final batch and masks it — the run must stay finite and visit every
    positive (protocol parity with the host loop)."""
    n = 200
    e = ring_graph(n)  # 400 directed edges
    x = rng.normal(size=(n, 8)).astype(np.float32)
    cfg = lpm.LinkPredConfig(encoder="SAGE", predictor="DOT",
                             use_node_feats=True, train_node_emb=False,
                             eval_metric="mrr", batch_size=96)
    out = lpm.train_linkpred(cfg, x, e, n, epochs=2, runs=1)
    assert np.isfinite(out["stats"]["test_mean"])


def test_hash_membership_matches_searchsorted(rng):
    """Membership (hash buckets + spill) == the sorted-array searchsorted
    test on every candidate, incl. keys that collide with the sentinel and
    overflowing buckets (tiny table forces spills)."""
    n = 500
    e = np.stack([rng.integers(0, n, 4000), rng.integers(0, n, 4000)])
    keys = sampling.edge_keys(e, n)
    m = sampling.build_membership(keys)
    assert m.buckets.shape[0] * 8 >= 1
    src = jnp.asarray(np.concatenate([e[0], rng.integers(0, n, 5000)]))
    dst = jnp.asarray(np.concatenate([e[1], rng.integers(0, n, 5000)]))
    got = jax.jit(sampling._is_member)(m, src, dst)
    ref = jax.jit(sampling._is_member)(jnp.asarray(keys), src, dst)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # real edges must all be members
    assert bool(np.asarray(got)[: e.shape[1]].all())


def test_neg_sample_with_membership_avoids_edges(rng):
    n = 300
    e = np.stack([rng.integers(0, n, 2000), rng.integers(0, n, 2000)])
    m = sampling.build_membership(sampling.edge_keys(e, n))
    neg = sampling.global_neg_sample(jax.random.PRNGKey(0), m, n, 64, 3)
    keys = set(map(tuple, np.stack([e[0], e[1]], 1)))
    flat = np.asarray(neg).reshape(-1, 2)
    bad = sum((int(a), int(b)) in keys or a == b for a, b in flat)
    assert bad <= 2


def test_global_perm_neg_sample_perm_within_groups():
    """perm_within=g: copies are per-GROUP permutations of the base draw
    (the epoch-batched path must preserve each step's permute-within-the-
    minibatch semantics), with independent permutations across groups."""
    n, total, grp = 101, 64, 16
    e = ring_graph(n)
    keys = jnp.asarray(sampling.edge_keys(e, n))
    neg = np.asarray(sampling.global_perm_neg_sample(
        jax.random.PRNGKey(3), keys, n, total, 3, grp))
    assert neg.shape == (total, 3, 2)
    base = neg[:, 0, :]
    diff_perms = 0
    for c in range(1, 3):
        copy = neg[:, c, :]
        perms = []
        for g0 in range(0, total, grp):
            b = base[g0:g0 + grp]
            cp = copy[g0:g0 + grp]
            # each group's copy is a permutation of its own base rows
            bs = {tuple(r) for r in b.tolist()}
            cs = {tuple(r) for r in cp.tolist()}
            assert bs == cs
            perms.append(tuple(map(tuple, cp.tolist())))
        diff_perms += len(set(perms))
    assert diff_perms > 4  # groups got distinct permutations


def test_global_perm_neg_sample_default_whole_batch():
    n, total = 101, 48
    e = ring_graph(n)
    keys = jnp.asarray(sampling.edge_keys(e, n))
    neg = np.asarray(sampling.global_perm_neg_sample(
        jax.random.PRNGKey(4), keys, n, total, 2))
    base = {tuple(r) for r in neg[:, 0, :].tolist()}
    copy = {tuple(r) for r in neg[:, 1, :].tolist()}
    assert base == copy
