"""Transfer-setting graph surgery."""
import numpy as np
import pytest

from gnn_tail_generalization.linkpred import surgery
from gnn_tail_generalization.linkpred.surgery import GraphData


def make_graph(rng, n=100, e=400, with_years=True):
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = src != dst
    ei = np.stack([src[keep], dst[keep]])
    m = ei.shape[1]
    return GraphData(
        x=rng.normal(size=(n, 8)).astype(np.float32),
        edge_index=ei,
        node_year=rng.integers(2010, 2019, n) if with_years else None,
        edge_year=rng.integers(2010, 2019, m) if with_years else None,
        keys=np.arange(n),
    )


def test_subgraph_relabel_and_isolated_removal(rng):
    g = make_graph(rng)
    sub = surgery.down_sample_graph_with_node_perm(g, drop_rate=0.5, seed=0)
    assert sub.n_node <= 50
    assert sub.edge_index.max() < sub.n_node
    # no isolated nodes
    used = np.zeros(sub.n_node, bool)
    used[sub.edge_index.reshape(-1)] = True
    assert used.all()
    # carried attributes align
    assert sub.node_year.shape[0] == sub.n_node
    assert sub.edge_year.shape[0] == sub.edge_index.shape[1]


def test_cal_union_shared_nodes(rng):
    g1 = make_graph(rng, n=30, e=60)
    g2 = make_graph(rng, n=40, e=80)
    # overlap: keys 20..29 of g1 == keys 0..9 of g2
    g1.keys = np.arange(0, 30)
    g2.keys = np.arange(20, 60)
    u = surgery.cal_union(g1, g2)
    # union size = 40 + 20 unshared g1 nodes
    assert u.n_node == 60
    # target-exclusive nodes: g2-only keys (30..59) = 30 nodes
    assert u.is_unique_in_targetG_mask.sum() == 30
    assert u.edge_index.max() < u.n_node


def test_target_seeded_by_source(rng):
    g1 = make_graph(rng, n=30, e=60)
    g2 = make_graph(rng, n=40, e=80)
    g1.keys = np.arange(0, 30)
    g2.keys = np.arange(20, 60)
    out = surgery.target_seeded_by_source(g1, g2)
    assert out.n_node == 40
    # only 10 shared nodes -> unique mask has 30 True
    assert out.is_unique_in_targetG_mask.sum() == 30
    # edges at least as many as g2's coalesced set
    assert out.edge_index.shape[1] >= len(
        set(zip(*g2.edge_index.tolist()))
    ) - 1


def test_init_split_edge_unified_source_edges_all_train(rng):
    g = make_graph(rng)
    unique = rng.random(100) < 0.5
    g.is_unique_in_targetG_mask = unique
    se = surgery.init_split_edge_unified(g, seed=0)
    e = g.edge_index
    cond0 = (~unique[e[0]]) & (~unique[e[1]])
    # every cond0 edge must land in train
    train_set = set(map(tuple, se["train"]["edge"].tolist()))
    for s, d in e[:, cond0].T.tolist():
        assert (s, d) in train_set
    total = sum(se[k]["edge"].shape[0] for k in ("train", "valid", "test"))
    assert total == e.shape[1]


@pytest.mark.parametrize("setting", ["t2t", "u2t", "i2t", "s", "i"])
def test_transfer_surgery_node_year(rng, setting):
    g = make_graph(rng, n=200, e=1000)
    out, se = surgery.transfer_surgery_node_year(g, setting, lo=2013,
                                                 hi=2016, drop_rate=0.1)
    assert out.edge_index.max() < out.n_node
    for k in ("train", "valid", "test"):
        assert se[k]["edge"].shape[1] == 2
        assert se[k]["edge_neg"].shape[1] == 2
    if setting in ("t2t", "i2t"):
        assert (out.node_year >= 2013).all()


@pytest.mark.parametrize("setting", ["t2t", "i2t", "s", "i"])
def test_transfer_surgery_edge_year(rng, setting):
    g = make_graph(rng, n=200, e=1000)
    out, se = surgery.transfer_surgery_edge_year(g, setting, lo=2013,
                                                 hi=2016, drop_rate=0.1)
    assert out.edge_index.shape[1] == out.edge_year.shape[0]
    if setting == "t2t":
        assert (out.edge_year >= 2013).all()


def test_transfer_split_feeds_linkpred_trainer(rng):
    from gnn_tail_generalization.linkpred import model as lpm

    g = make_graph(rng, n=120, e=900)
    out, se = surgery.transfer_surgery_node_year(g, "i2t", lo=2012, hi=2016)
    cfg = lpm.LinkPredConfig(encoder="SAGE", predictor="DOT",
                             batch_size=128, num_neg=2, eval_metric="hits")
    res = lpm.train_linkpred(cfg, out.x, out.edge_index, out.n_node,
                             epochs=2, runs=1, split_edge=se)
    assert "Hits@20" in res["last_results"]
