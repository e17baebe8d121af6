"""Hand-computed GCN-layer math parity (SURVEY.md section 4: allclose per
layer against the documented formulas of GNN_model/GCN.py:205-250)."""
import numpy as np
import jax
import jax.numpy as jnp

from gnn_tail_generalization.graph import core
from gnn_tail_generalization.nn.backbone import TricksCombBackbone
from gnn_tail_generalization.nn.gcn import GCNConv
from gnn_tail_generalization.nn import norms
from gnn_tail_generalization.ops.topk_attention import latent_neighbor_replace


def small_graph(rng, n=12, e=40):
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    ei = core.standard_pipeline(np.stack([src, dst]), n)
    g = core.build_graph(ei, n)
    return g, ei


def manual_gcn_layer(ei, n, x, w, b, se=None):
    dout = np.maximum(np.bincount(ei[0], minlength=n), 1).astype(np.float64)
    din = np.maximum(np.bincount(ei[1], minlength=n), 1).astype(np.float64)
    h = (x * dout[:, None] ** -0.5) @ w
    if se is not None:
        h = h + se
    a = np.zeros((n, n))
    np.add.at(a, (ei[1], ei[0]), 1.0)
    y = a @ h
    return y * din[:, None] ** -0.5 + b


def test_gcnconv_matches_manual(rng):
    n = 12
    g, ei = small_graph(rng, n)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    conv = GCNConv(out_feats=3, n_node=n, has_se=True)
    vs = conv.init(jax.random.PRNGKey(0), g, jnp.asarray(x))
    y, se_reg = conv.apply(vs, g, jnp.asarray(x))
    w = np.asarray(vs["params"]["kernel"])
    b = np.asarray(vs["params"]["bias"])
    se = np.asarray(vs["params"]["se"])
    expect = manual_gcn_layer(ei, n, x, w, b, se)
    np.testing.assert_allclose(np.asarray(y), expect, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        float(se_reg), np.linalg.norm(se), rtol=1e-5
    )


def test_backbone_two_layer_plain_gcn(rng):
    """num_layers=2, no tricks: y = GCN2(relu(GCN1(x))) with dropout off in
    eval mode (GCN.py:109-131 non-residual path)."""
    n = 12
    g, ei = small_graph(rng, n)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    bb = TricksCombBackbone(
        num_feats=5, num_classes=3, dim_hidden=8, num_layers=2, n_node=n,
        type_trick="NoResNodeNorm",  # best-config style: norms built, unapplied
        dropout=0.6, whetherHasSE=(0, 0, 0),
    )
    vs = bb.init(jax.random.PRNGKey(1), g, jnp.asarray(x), train=False)
    y, se_reg, les = bb.apply(
        vs, g, jnp.asarray(x), train=False, want_les=True
    )
    p = vs["params"]
    h1 = manual_gcn_layer(
        ei, n, x, np.asarray(p["conv_0"]["kernel"]),
        np.asarray(p["conv_0"]["bias"]),
    )
    h1r = np.maximum(h1, 0)
    h2 = manual_gcn_layer(
        ei, n, h1r, np.asarray(p["conv_1"]["kernel"]),
        np.asarray(p["conv_1"]["bias"]),
    )
    np.testing.assert_allclose(np.asarray(y), h2, rtol=1e-4, atol=1e-4)
    assert se_reg is None
    # les = [post-layer1 (pre-relu), post-layer2] concat
    np.testing.assert_allclose(np.asarray(les[:, :8]), h1, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(les[:, 8:]), h2, rtol=1e-4, atol=1e-4)
    assert les.shape[1] == bb.se_dim()


def test_backbone_initial_connection_path(rng):
    """Residual-trick path: input MLP + hidden convs + out proj
    (GCN.py:103-138)."""
    n = 12
    g, ei = small_graph(rng, n)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    bb = TricksCombBackbone(
        num_feats=5, num_classes=3, dim_hidden=8, num_layers=3, n_node=n,
        type_trick="Initial+BatchNorm", res_alpha=0.2, dropout=0.0,
        whetherHasSE=(1, 1, 1),
    )
    vs = bb.init(jax.random.PRNGKey(2), g, jnp.asarray(x), train=False)
    y, se_reg, les = bb.apply(
        vs, g, jnp.asarray(x), train=False, want_les=True
    )
    assert y.shape == (n, 3)
    # all 3 convs are hidden->hidden with SE flag [1] => 3 SE tables
    assert les.shape[1] == 3 * 8 == bb.se_dim()
    assert se_reg is not None and float(se_reg) > 0

    p = vs["params"]
    # manual: input mlp
    h0 = np.maximum(
        x @ np.asarray(p["Dense_0"]["kernel"]) + np.asarray(p["Dense_0"]["bias"]),
        0,
    )
    xs = [h0]
    h = h0
    for i in range(3):
        se = np.asarray(p[f"conv_{i}"]["se"])
        hi = manual_gcn_layer(
            ei, n, h, np.asarray(p[f"conv_{i}"]["kernel"]),
            np.asarray(p[f"conv_{i}"]["bias"]), se,
        )
        hir = np.maximum(hi, 0)
        xs.append(hir)
        h = (1 - 0.2) * xs[-1] + 0.2 * xs[0]
    out = h @ np.asarray(p["out_mlp"]["kernel"]) + np.asarray(p["out_mlp"]["bias"])
    np.testing.assert_allclose(np.asarray(y), out, rtol=1e-4, atol=1e-4)


def test_pair_and_node_norm_formulas(rng):
    x = rng.normal(size=(10, 6)).astype(np.float32)
    pn = np.asarray(norms.pair_norm(jnp.asarray(x)))
    xc = x - x.mean(0)
    expect = xc / np.sqrt(1e-6 + (xc**2).sum(1).mean())
    np.testing.assert_allclose(pn, expect, rtol=1e-5, atol=1e-5)

    nn_ = np.asarray(norms.node_norm(jnp.asarray(x), "n"))
    expect = (x - x.mean(1, keepdims=True)) / np.sqrt(
        x.var(1, keepdims=True) + 1e-5
    )
    np.testing.assert_allclose(nn_, expect, rtol=1e-4, atol=1e-4)


def test_norm_applies_exact_match_only():
    assert norms.norm_applies("BatchNorm")
    assert not norms.norm_applies("Initial+BatchNorm")
    assert not norms.norm_applies("NoResNodeNorm")


def test_latent_neighbor_replace_matches_naive_loop(rng):
    b, n, d, k = 7, 20, 6, 3
    guess = rng.normal(size=(b, d)).astype(np.float32)
    se = rng.normal(size=(n, d)).astype(np.float32)
    out = np.asarray(
        latent_neighbor_replace(jnp.asarray(guess), jnp.asarray(se), k)
    )
    # naive per-row reference (MLP_model/__init__.py:143-156 semantics)
    for i in range(b):
        scores = guess[i] @ se.T
        sel = np.argsort(scores)[-k:]
        a = np.exp(scores[sel] - scores[sel].max())
        a = a / a.sum()
        expect = a @ se[sel]
        np.testing.assert_allclose(out[i], expect, rtol=1e-4, atol=1e-4)


def test_latent_neighbor_replace_chunked_matches(rng):
    b, n, d, k = 50, 30, 6, 3
    guess = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
    se = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    full = latent_neighbor_replace(guess, se, k)
    chunked = latent_neighbor_replace(guess, se, k, row_chunk=16)
    np.testing.assert_allclose(np.asarray(full), np.asarray(chunked),
                               rtol=1e-5, atol=1e-5)


def test_latent_neighbor_replace_bf16_scores(rng):
    """bf16-scored selection agrees with the f32 path on well-separated
    scores (f32 accumulation keeps ranking stable)."""
    import jax.numpy as jnp
    from gnn_tail_generalization.ops.topk_attention import (
        latent_neighbor_replace,
    )

    # well-separated scores: each guess row is a scaled copy of 3 distinct
    # SE rows, so the top-3 ranking has wide margins (near-ties are
    # legitimately allowed to resolve differently under operand rounding)
    se = rng.normal(size=(200, 24)).astype(np.float32)
    guess = np.stack([
        2.0 * se[i] + 1.0 * se[i + 50] + 0.5 * se[i + 100]
        for i in range(16)
    ]).astype(np.float32)
    a = latent_neighbor_replace(jnp.asarray(guess), jnp.asarray(se), 3)
    b = latent_neighbor_replace(jnp.asarray(guess), jnp.asarray(se), 3,
                                score_dtype=jnp.bfloat16)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-2,
                               atol=5e-2)
