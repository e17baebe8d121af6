"""Raw-file dataset readers, exercised on synthetic files written to tmp."""
import gzip
import os
import pickle

import numpy as np
import scipy.sparse as ssp

from gnn_tail_generalization.config import build_config
from gnn_tail_generalization.data import ogb, planetoid, webkb
from gnn_tail_generalization.data.datasets import load_dataset


def write_planetoid(tmp, name="cora", n_allx=60, n_test=20, d=10, c=3):
    rng = np.random.default_rng(0)
    os.makedirs(tmp / "Cora" / "raw", exist_ok=True)
    root = tmp / "Cora" / "raw"
    n = n_allx + n_test

    def dump(obj, suffix):
        with open(root / f"ind.{name}.{suffix}", "wb") as f:
            pickle.dump(obj, f)

    allx = ssp.csr_matrix(rng.random((n_allx, d)).astype(np.float32))
    tx = ssp.csr_matrix(rng.random((n_test, d)).astype(np.float32))
    onehot = np.eye(c)
    y = onehot[rng.integers(0, c, 20)]
    ally = onehot[rng.integers(0, c, n_allx)]
    ty = onehot[rng.integers(0, c, n_test)]
    graph = {i: [int(v) for v in rng.integers(0, n, 3)] for i in range(n)}
    test_idx = rng.permutation(np.arange(n_allx, n))
    dump(allx.tocsc() if False else allx, "allx")
    dump(ssp.csr_matrix(rng.random((20, d)).astype(np.float32)), "x")
    dump(tx, "tx")
    dump(y, "y")
    dump(ally, "ally")
    dump(ty, "ty")
    dump(graph, "graph")
    np.savetxt(root / f"ind.{name}.test.index", test_idx, fmt="%d")
    return n, d, c


def test_planetoid_reader(tmp_path):
    n, d, c = write_planetoid(tmp_path)
    data = planetoid.load_planetoid(str(tmp_path), "Cora")
    assert data.x.shape == (n, d)
    assert data.y.shape == (n,)
    assert data.train_mask.sum() == 20
    assert data.val_mask.sum() == min(500, n - 20)  # 500-block, toy-capped
    assert data.test_mask.sum() == 20
    # row-normalized
    s = data.x.sum(axis=1)
    np.testing.assert_allclose(s[s > 0], 1.0, rtol=1e-5)


def test_ogbn_arxiv_reader(tmp_path):
    rng = np.random.default_rng(0)
    n, d = 50, 8
    raw = tmp_path / "ogbn_arxiv" / "raw"
    os.makedirs(raw, exist_ok=True)
    split = tmp_path / "ogbn_arxiv" / "split" / "time"
    os.makedirs(split, exist_ok=True)

    def gz_save(path, arr, fmt):
        with gzip.open(path, "wt") as f:
            np.savetxt(f, arr, delimiter=",", fmt=fmt)

    e = rng.integers(0, n, (100, 2))
    gz_save(raw / "edge.csv.gz", e, "%d")
    gz_save(raw / "node-feat.csv.gz", rng.random((n, d)), "%.4f")
    gz_save(raw / "node-label.csv.gz", rng.integers(0, 5, (n, 1)), "%d")
    idx = rng.permutation(n)
    gz_save(split / "train.csv.gz", idx[:30, None], "%d")
    gz_save(split / "valid.csv.gz", idx[30:40, None], "%d")
    gz_save(split / "test.csv.gz", idx[40:, None], "%d")

    data = ogb.load_ogbn_arxiv(str(tmp_path))
    assert data.x.shape == (n, d)
    assert data.train_mask.sum() == 30
    # undirected
    s = set(zip(*data.edge_index.tolist()))
    assert all((b, a) in s for a, b in s)


def test_webkb_reader(tmp_path):
    d = tmp_path / "TEXAS" / "raw"
    os.makedirs(d, exist_ok=True)
    with open(d / "out1_node_feature_label.txt", "w") as f:
        f.write("id\tfeat\tlabel\n")
        for i in range(10):
            feats = ",".join(str((i + j) % 2) for j in range(5))
            f.write(f"{i}\t{feats}\t{i % 3}\n")
    with open(d / "out1_graph_edges.txt", "w") as f:
        f.write("src\tdst\n")
        for i in range(9):
            f.write(f"{i}\t{i+1}\n")
    data = webkb.load_webkb_like(str(tmp_path), "TEXAS", which_split=0)
    assert data.x.shape == (10, 5)
    assert data.edge_index.shape == (2, 9)
    assert data.train_mask.sum() + data.val_mask.sum() + data.test_mask.sum() == 10


def test_load_dataset_fallback_synthetic():
    cfg = build_config(dataset="Citeseer", train_which="TeacherGNN")
    data = load_dataset(cfg, data_root="/nonexistent")
    assert data.name.startswith("synthetic")
    assert data.x.shape == (3327, 3703)
