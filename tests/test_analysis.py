import numpy as np

from gnn_tail_generalization.graph import analysis


def test_partial_sorted_idx_median_halving():
    arr = np.arange(64)
    top3 = analysis.partial_sorted_idx(arr, "top3")
    # 5 halvings of <= median keeps ties: 64 -> 33 -> 17 -> 9 -> 5 -> 3
    assert arr[top3].max() <= np.median(arr)
    assert len(top3) <= 5
    bottom3 = analysis.partial_sorted_idx(arr, "bottom3")
    assert arr[bottom3].min() >= np.median(arr)


def test_degree_splits_special():
    rng = np.random.default_rng(0)
    n = 512
    # power-law-ish degrees
    src = rng.integers(0, n, 3000)
    dst = (rng.pareto(1.5, 3000) * 10).astype(int) % n
    e = np.stack([src, dst])
    sp = analysis.degree_splits(n, e, use_special_split=True)
    assert sp.zero_deg_idx is not None
    # zero cohort has the lowest degrees of the top6 subset
    _, din = analysis.degree_census(n, e)
    assert din[sp.zero_deg_idx].max() <= din[sp.small_deg_idx].min()
    # head nodes have high degree
    assert np.median(din[sp.large_deg_idx]) >= np.median(din)
    # masks consistent
    assert sp.zero_deg_mask.sum() == len(sp.zero_deg_idx)


def test_craft_isolation_removes_only_nonself_edges():
    e = np.array([[0, 1, 2, 2, 3], [1, 0, 2, 3, 3]])
    zero_mask = np.array([True, False, False, False])
    crafted, bkup = analysis.craft_isolation(e, zero_mask)
    s = set(zip(crafted[0].tolist(), crafted[1].tolist()))
    assert (0, 1) not in s and (1, 0) not in s  # edges touching node 0 gone
    assert (2, 2) in s and (2, 3) in s and (3, 3) in s
    assert bkup.shape == e.shape


def test_craft_isolation_keeps_self_loop_of_isolated_node():
    e = np.array([[0, 0, 1], [0, 1, 1]])
    zero_mask = np.array([True, False])
    crafted, _ = analysis.craft_isolation(e, zero_mask)
    s = set(zip(crafted[0].tolist(), crafted[1].tolist()))
    assert (0, 0) in s  # self loop kept (craft_isolation_v2 ori!=dst guard)
    assert (0, 1) not in s
