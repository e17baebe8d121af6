"""GIN pretrainers and structural pretraining."""
import numpy as np
import jax
import jax.numpy as jnp

from gnn_tail_generalization.baselines import structure_pretrain as sp
from gnn_tail_generalization.baselines.pretrain_gin import train_pretrain_gin
from gnn_tail_generalization.graph import core


def graph_and_feats(rng, n=50):
    e = core.standard_pipeline(
        np.stack([rng.integers(0, n, 200), rng.integers(0, n, 200)]), n)
    g = core.build_graph(e, n)
    x = jnp.asarray(rng.normal(size=(n, 12)).astype(np.float32))
    return g, x, e


def test_masking_gin_trains(rng):
    g, x, _ = graph_and_feats(rng)
    embs, _ = train_pretrain_gin(g, x, "masking", hidden_dim=16, epochs=8)
    assert embs.shape == (50, 16)
    assert np.isfinite(np.asarray(embs)).all()


def test_contextpred_gin_trains(rng):
    g, x, _ = graph_and_feats(rng)
    embs, _ = train_pretrain_gin(g, x, "contextpred", hidden_dim=16,
                                 epochs=8)
    assert embs.shape == (50, 16)
    assert np.isfinite(np.asarray(embs)).all()


def test_ntn_decoder_shapes(rng):
    dec = sp.NTNDecoder(tensor_dim=4)
    u = jnp.asarray(rng.normal(size=(7, 8)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(7, 8)).astype(np.float32))
    vs = dec.init(jax.random.PRNGKey(0), u, v)
    out = dec.apply(vs, u, v)
    assert out.shape == (7,)


def test_struct_pretrain_loss_finite(rng):
    g, x, e = graph_and_feats(rng)
    # masked graph: drop 30% edges
    keep = rng.random(e.shape[1]) > 0.3
    gm = core.build_graph(e[:, keep], 50)
    model = sp.StructFeatPretrain(hidden_dim=16, num_layers=2)

    link_edges = jnp.asarray(
        np.stack([rng.integers(0, 50, 32), rng.integers(0, 50, 32)], axis=1))
    link_labels = jnp.asarray(rng.integers(0, 2, 32))
    cents = sp.compute_centralities(e, 50)
    pairs = np.stack([rng.integers(0, 50, 32), rng.integers(0, 50, 32)],
                     axis=1)
    cent_labels = jnp.asarray(
        (cents[pairs[:, 0]] > cents[pairs[:, 1]]).astype(np.int32))
    pairs = jnp.asarray(pairs)

    k = jax.random.PRNGKey(0)
    variables = model.init({"params": k}, g, gm, x, link_edges, link_labels,
                           pairs, cent_labels, train=True)
    loss, _ = model.apply(variables, g, gm, x, link_edges, link_labels,
                          pairs, cent_labels, train=True,
                          mutable=["batch_stats"])
    assert np.isfinite(float(loss))


def test_context_graph_builder_ring():
    """On a directed ring, the context of center c at (l1=1, l2=3) is
    exactly {c+1, c+2, c+3}; overlap (k_sub=2) is {c+1, c+2}; context
    edges are the chain between consecutive ring nodes."""
    import numpy as np
    from gnn_tail_generalization.baselines.pretrain_gin import (
        build_context_graphs,
    )

    n = 12
    e = np.stack([np.arange(n), (np.arange(n) + 1) % n])
    centers = np.asarray([0, 5])
    cg, idx, nmask, omask = build_context_graphs(
        e, n, centers, l1=1, l2=3, k_sub=2, max_nodes=8)
    m = 8
    for bi, c in enumerate(centers):
        sl = slice(bi * m, (bi + 1) * m)
        got = set(np.asarray(idx[sl])[np.asarray(nmask[sl]) > 0])
        assert got == {(c + 1) % n, (c + 2) % n, (c + 3) % n}
        ov = set(np.asarray(idx[sl])[np.asarray(omask[sl]) > 0])
        assert ov == {(c + 1) % n, (c + 2) % n}
    # union graph has exactly the 2 chain edges per center
    w = np.asarray(cg.edge_weight)
    assert int((w > 0).sum()) == 4
