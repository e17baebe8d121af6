import numpy as np
import jax.numpy as jnp

from gnn_tail_generalization.graph import core


def toy_edges():
    # 4 nodes, directed edges incl. a duplicate and a self loop
    return np.array([[0, 1, 1, 2, 3, 3], [1, 0, 2, 3, 3, 2]])


def test_symmetrize_dedups_and_adds_reverse():
    e = core.symmetrize(toy_edges(), 4)
    s = set(zip(e[0].tolist(), e[1].tolist()))
    assert (0, 1) in s and (1, 0) in s
    assert (3, 2) in s and (2, 3) in s
    assert (3, 3) in s  # self loop kept by symmetrize
    assert len(s) == e.shape[1]  # dedup


def test_standard_pipeline_self_loops():
    e = core.standard_pipeline(toy_edges(), 4)
    s = set(zip(e[0].tolist(), e[1].tolist()))
    for i in range(4):
        assert (i, i) in s
    # exactly one self loop per node
    n_loops = sum(1 for a, b in zip(e[0], e[1]) if a == b)
    assert n_loops == 4


def test_degrees_count_self_loops_and_duplicates():
    e = np.array([[0, 0, 1, 2], [1, 1, 1, 2]])
    dout, din = core.degrees(e, 3)
    assert dout.tolist() == [2, 1, 1]
    assert din.tolist() == [0, 3, 1]


def test_build_graph_sorted_and_padded():
    e = toy_edges()
    g = core.build_graph(e, 4, pad_multiple=8)
    assert g.e_pad == 8 and g.n_edge == 6
    recv = np.asarray(g.receivers)
    assert np.all(np.diff(recv) >= 0)  # dst-sorted incl padding
    assert np.asarray(g.edge_weight)[6:].tolist() == [0.0, 0.0]
    recv_t = np.asarray(g.receivers_t)
    assert np.all(np.diff(recv_t) >= 0)  # transposed view sorted by its dst


def test_gcn_norm_weights():
    # triangle graph + self loops
    e = np.array([[0, 1, 1, 2, 0, 2], [1, 0, 2, 1, 0, 2]])
    e = core.standard_pipeline(e, 3)
    w = core.gcn_norm_weights(e, 3)
    # node1 has degree 3 (0,2,self), nodes 0/2 degree 2
    dense = np.zeros((3, 3))
    dense[e[1], e[0]] = w
    d = np.array([2, 3, 2], dtype=float)
    a = np.zeros((3, 3))
    a[e[1], e[0]] = 1
    expect = a / np.sqrt(d)[:, None] / np.sqrt(d)[None, :]
    np.testing.assert_allclose(dense, expect, rtol=1e-6)


def test_subgraph_relabel():
    e = toy_edges()
    sub, _ = core.subgraph_edges(e, np.array([1, 2, 3]), 4)
    # edges among {1,2,3} relabeled to {0,1,2}
    s = set(zip(sub[0].tolist(), sub[1].tolist()))
    assert (0, 1) in s  # 1->2
    assert (2, 2) in s  # 3->3 self loop
    assert all(v < 3 for v in sub.flatten())
