"""Edgewise (I2-GTL) teacher loss: samplers, loss/MRR, full loop."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from gnn_tail_generalization.config import build_config
from gnn_tail_generalization.data.datasets import prepare
from gnn_tail_generalization.data.synthetic import synthetic_planetoid
from gnn_tail_generalization.train import edgewise, loops


def setup():
    cfg = build_config(dataset="Cora", train_which="TeacherGNN",
                       exp_mode="I2_GTL")
    cfg = dataclasses.replace(
        cfg, N_nodes=200, num_feats=40, num_classes=4, samp_size_p=32,
        samp_size_n_train=32, samp_size_n_test_times_p=2,
    )
    data = synthetic_planetoid(n_node=200, n_feat=40, n_class=4, seed=3,
                               name="s")
    data.train_mask = np.zeros(200, bool)
    data.train_mask[np.random.default_rng(0).permutation(200)[:100]] = True
    data.test_mask = ~data.train_mask
    pd = prepare(data, cfg)
    return cfg, pd


def test_edgewise_plan_split_membership():
    cfg, pd = setup()
    plan = edgewise.build_edgewise_plan(cfg, pd)
    tm = pd.train_mask
    e = plan.train_edges
    assert (tm[e[0]] & tm[e[1]]).all()
    e = plan.test_edges
    assert ((~tm)[e[0]] & (~tm)[e[1]]).all()


def test_negative_sampling_respects_split():
    cfg, pd = setup()
    plan = edgewise.build_edgewise_plan(cfg, pd)
    tm = pd.train_mask
    src, dst = edgewise._sample_split_negatives(
        jax.random.PRNGKey(0), jnp.asarray(plan.keys_sorted),
        jnp.asarray(tm), jnp.asarray(np.where(tm)[0]),
        jnp.asarray(np.where(~tm)[0]), plan.n_node, 64, "train",
    )
    frac_ok = (tm[np.asarray(src)] & tm[np.asarray(dst)]).mean()
    assert frac_ok > 0.95  # fixed-rounds resampling: near-all valid


def test_linkp_loss_and_mrr():
    pos = jnp.asarray([2.0, 1.0])
    neg = jnp.asarray([0.0, 3.0, 0.0, 0.0])  # 2 per positive
    loss, mrr = edgewise.linkp_loss_eva(pos, neg)
    # pos[0]=2 vs negs [0,3]: rank 2 -> 1/2; pos[1]=1 vs [0,0]: rank 1 -> 1
    np.testing.assert_allclose(float(mrr), 0.75, rtol=1e-6)
    assert float(loss) > 0


def test_teacher_i2gtl_records_linkp():
    cfg, pd = setup()
    res = loops.train_teacher(cfg, pd, epochs=8)
    assert "linkp_train" in res.columns and "linkp_test" in res.columns
    assert np.isfinite(res.records).all()
    # mrr bounded (0, 1]
    lt = res.records[:, res.columns.index("linkp_train")]
    assert (lt > 0).all() and (lt <= 1).all()
