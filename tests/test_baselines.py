"""Self-supervised baselines: DGI/EGI/VGAE pretraining, MI measures, bound."""
import numpy as np
import jax
import jax.numpy as jnp

from gnn_tail_generalization.baselines import api, egi_bound, mi
from gnn_tail_generalization.graph import core
from gnn_tail_generalization.utils.records import TensorRex, save_curve, load_curve


def ring(n=60, extra=80, seed=0):
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(n), rng.integers(0, n, extra)])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, extra)])
    return np.stack([src, dst])


def test_mi_measures_finite():
    p = jnp.asarray([1.0, 2.0, -0.5])
    q = jnp.asarray([0.3, -1.0, 0.1])
    for m in ["GAN", "JSD", "X2", "KL", "RKL", "DV", "H2", "W1"]:
        loss = mi.fenchel_dual_loss(p, q, m)
        assert np.isfinite(float(loss)), m


def test_degree_bucketing():
    e = ring()
    x = api.degree_bucketing(e, 60, max_degree=8)
    assert x.shape == (60, 8)
    assert (x.sum(axis=1) == 1).all()


def test_gen_baseline_embs_all_algs():
    e = ring()
    for alg in ["DGI", "EGI", "VGAE"]:
        embs = api.gen_baseline_embs(e, 60, alg, epochs=5)
        assert embs.shape[0] == 60
        assert np.isfinite(embs).all(), alg


def test_dgi_loss_decreases():
    from gnn_tail_generalization.baselines.dgi import train_dgi

    e = core.standard_pipeline(ring(), 60)
    g = core.build_graph(e, 60)
    x = jnp.asarray(api.degree_bucketing(e, 60))
    embs, _ = train_dgi(g, x, hidden_dim=16, epochs=15)
    assert embs.shape == (60, 16)


def test_egi_bound_zero_for_identical_graphs():
    e = ring()
    b_same = egi_bound.egi_bound(e, 60, e, 60, n_pairs=8, seed=0)
    # identical graphs: ego structures drawn from the same distribution ->
    # small (not exactly 0 since centers differ); different topology bigger
    e2 = ring(60, extra=400, seed=5)
    b_diff = egi_bound.egi_bound(e, 60, e2, 60, n_pairs=8, seed=0)
    assert b_same >= 0 and np.isfinite(b_same)
    assert np.isfinite(b_diff)


def test_tensor_rex_roundtrip(tmp_path):
    p = str(tmp_path / "rex.npy")
    rex = TensorRex(p, (2, 3), record_len=4)
    assert not rex.is_done((0, 1))
    rex.record((0, 1), np.array([1, 2, 3]))  # shorter than record_len
    rex2 = TensorRex(p, (2, 3), record_len=4)
    assert rex2.is_done((0, 1))
    np.testing.assert_array_equal(rex2.values((0, 1)), [1, 2, 3, 0])


def test_save_load_curve(tmp_path):
    c = np.arange(5.0)
    save_curve(c, "acc", str(tmp_path))
    np.testing.assert_array_equal(load_curve("acc", str(tmp_path)), c)


def test_ego_flow_sampler_structure(rng):
    """Hop-t edges go frontier -> sampled IN-neighbor; masks kill frontier
    nodes without predecessors; frontiers chain across hops."""
    from gnn_tail_generalization.baselines.egi import sample_ego_flows

    e = ring()
    n, hops, fanout = 60, 2, 3
    seeds = np.asarray([5, 17, 40])
    fl = sample_ego_flows(e, n, seeds, hops, fanout,
                          np.random.default_rng(0))
    assert fl.src.shape == (hops, len(seeds) * fanout ** hops)
    src0 = np.asarray(fl.src[0][: len(seeds) * fanout])
    dst0 = np.asarray(fl.dst[0][: len(seeds) * fanout])
    m0 = np.asarray(fl.mask[0][: len(seeds) * fanout])
    assert (src0 == np.repeat(seeds, fanout)).all()
    # each sampled neighbor is a true in-neighbor of its seed
    adj = {u: set(e[0][e[1] == u]) for u in seeds}
    for s, d, m in zip(src0, dst0, m0):
        if m > 0:
            assert d in adj[s]
    # hop-1 sources are the hop-0 destinations (hop 0 fills B*fanout slots)
    n0 = len(seeds) * fanout
    assert (np.asarray(fl.src[1][: n0 * fanout]).reshape(-1, fanout)[:, 0]
            == dst0).all()


def test_subg_discriminator_hop_semantics(rng):
    """Hop-0 scores must see m=0 and root=emb (apply_edges runs BEFORE the
    push, subgi.py:291); hop-1 scores see the pushed root means."""
    from gnn_tail_generalization.baselines.egi import (
        EgoFlows, SubGDiscriminator,
    )

    n, h, f = 10, 4, 4
    x = jnp.asarray(rng.normal(size=(n, f)).astype(np.float32))
    root = jnp.asarray(rng.normal(size=(n, h)).astype(np.float32))
    # one seed (node 0), one edge per hop: 0 -> 1 -> 2
    flows = EgoFlows(
        src=jnp.asarray([[0], [1]], jnp.int32),
        dst=jnp.asarray([[1], [2]], jnp.int32),
        mask=jnp.asarray([[1.0], [1.0]], jnp.float32),
        hops=2, e_max=1,
    )
    disc = SubGDiscriminator(h)
    vs = disc.init(jax.random.PRNGKey(0), flows, root, x)
    logits, masks = disc.apply(vs, flows, root, x)
    assert logits.shape == (2, 1) and np.asarray(masks).all()

    p = vs["params"]

    def dense(name, v):
        return v @ np.asarray(p[name]["kernel"]) + np.asarray(p[name]["bias"])

    relu = lambda a: np.maximum(a, 0.0)
    xn, rn = np.asarray(x), np.asarray(root)
    # hop 0: [root[0], m=0, x[1]]
    h0 = np.concatenate([rn[0], np.zeros(h), xn[1]])
    exp0 = dense("U_s", relu(dense("linear", h0)))[0]
    np.testing.assert_allclose(float(logits[0, 0]), exp0, rtol=1e-5)
    # push: m[1] = relu(fc_x(x[1]) + fc_x(x[0])), root[1] = root[0]
    m1 = relu(dense("fc_x", xn[1]) + dense("fc_x", xn[0]))
    h1 = np.concatenate([rn[0], m1, xn[2]])
    exp1 = dense("U_s", relu(dense("linear", h1)))[0]
    np.testing.assert_allclose(float(logits[1, 0]), exp1, rtol=1e-5)


def test_egi_trains_and_loss_moves(rng):
    from gnn_tail_generalization.baselines.egi import train_egi

    e_raw = ring()
    e = core.standard_pipeline(e_raw, 60)
    g = core.build_graph(e, 60)
    x = jnp.asarray(api.degree_bucketing(e, 60))
    embs, _ = train_egi(g, x, hidden_dim=12, epochs=8, edge_index=e,
                        batch_seeds=16, fanout=3)
    assert embs.shape == (60, 12)
    assert np.isfinite(np.asarray(embs)).all()
