"""Full-size dry run of the golden protocols on FAKE full-dimension data.

Real accuracy parity stays environment-blocked (zero egress, no raw
Planetoid files — tests/test_golden_numbers.py skips), but nothing else
should be untested on data-drop day: this runs the EXACT golden configs
(/root/reference/readme.md:47-73) at real Cora dimensions (2708 nodes,
1433 feats, 7 classes, 600-train special split, full 1500-epoch protocol)
through the real raw reader via a generated fake raw set — asserting the
pipeline is finite, deterministic, and that the learnable fake task
actually trains. VERDICT r3 item 6.
"""
import time

import numpy as np
import pytest


@pytest.fixture(scope="module")
def fake_cora_root(tmp_path_factory):
    from gnn_tail_generalization.data.synthetic import (
        write_fake_planetoid_raw,
    )

    root = tmp_path_factory.mktemp("fakedata")
    write_fake_planetoid_raw(str(root), "cora")
    return str(root)


def _load(root, **over):
    from gnn_tail_generalization.config import build_config
    from gnn_tail_generalization.data.datasets import (
        load_dataset, prepare,
    )

    cfg = build_config(dataset="Cora", want_headtail=True, num_layers=2,
                       use_special_split=True, **over)
    data = load_dataset(cfg, root)
    assert data.name == "Cora", "real raw reader did not fire"
    assert data.x.shape == (2708, 1433)
    return cfg, prepare(data, cfg)


def test_fake_raw_roundtrips_through_real_reader(fake_cora_root):
    from gnn_tail_generalization.data.planetoid import load_planetoid

    d = load_planetoid(fake_cora_root, "Cora")
    assert d.x.shape == (2708, 1433)
    assert d.train_mask.sum() == 140  # public split (pre special-split)
    assert d.test_mask.sum() == 1000
    assert d.y.max() == 6
    # row normalization happened
    s = d.x.sum(axis=1)
    np.testing.assert_allclose(s[s > 0], 1.0, rtol=1e-5)


@pytest.mark.slow
def test_golden_protocol_dryrun_traditional_gcn(fake_cora_root):
    """readme.md:47 protocol (SE=000) at full size, full 1500 epochs,
    epoch_block=100 — exactly what test_golden_cora_traditional_gcn runs
    per seed, on fake labels (finiteness + determinism, not accuracy)."""
    from gnn_tail_generalization.train import loops

    cfg, pd = _load(fake_cora_root, train_which="TeacherGNN",
                    whetherHasSE="000")
    t0 = time.time()
    res = loops.train_teacher(cfg, pd, seed=0, epoch_block=100)
    wall = time.time() - t0
    assert res.records.shape[0] == cfg.epochs == 1500
    assert np.isfinite(res.records).all()
    # the fake task is learnable: final test acc beats chance (100/7)
    assert res.best("acc_test") > 25.0
    res2 = loops.train_teacher(cfg, pd, seed=0, epoch_block=100)
    np.testing.assert_array_equal(res.records, res2.records)
    print(f"\ngolden dryrun GCN-000: 1500 epochs in {wall:.1f}s, "
          f"best acc_test {res.best('acc_test'):.2f}")


@pytest.mark.slow
def test_golden_protocol_dryrun_coldbrew_teacher(fake_cora_root):
    """readme.md:55 protocol (SE=100, se_reg=32) at full size."""
    from gnn_tail_generalization.train import loops

    cfg, pd = _load(fake_cora_root, train_which="TeacherGNN",
                    whetherHasSE="100", se_reg=32.0)
    t0 = time.time()
    res = loops.train_teacher(cfg, pd, seed=0, epoch_block=100)
    wall = time.time() - t0
    assert np.isfinite(res.records).all()
    assert res.best("acc_test") > 25.0
    print(f"\ngolden dryrun CB-teacher: 1500 epochs in {wall:.1f}s, "
          f"best acc_test {res.best('acc_test'):.2f}")


@pytest.mark.slow
def test_golden_protocol_dryrun_semlp_isolation(fake_cora_root):
    """readme.md:73 protocol (SEMLP topK=3, 2layer part1, dropout .5,
    adam 5e-3) at full size — teacher + part1 + part2, iso column."""
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
    data = load_dataset(cfg, fake_cora_root)
    assert data.name == "Cora"
    pd = prepare(data, cfg)
    t0 = time.time()
    res = loops.run_experiment(cfg, pd, seed=0, epoch_block=100)
    wall = time.time() - t0
    assert "iso" in res.columns
    assert np.isfinite(res.records).all()
    print(f"\ngolden dryrun SEMLP: full pipeline in {wall:.1f}s, "
          f"best iso {res.best('iso'):.2f}")


# ---- round 5: every remaining published golden row (VERDICT r4 next #5) --


@pytest.fixture(scope="module")
def fake_citeseer_root(tmp_path_factory):
    from gnn_tail_generalization.data.synthetic import (
        write_fake_planetoid_raw,
    )

    root = tmp_path_factory.mktemp("fakedata_cs")
    write_fake_planetoid_raw(str(root), "citeseer", n_node=3327,
                             n_feat=3703, n_class=6, n_allx=2327,
                             n_train=120, n_edge_und=4552)
    return str(root)


@pytest.fixture(scope="module")
def fake_pubmed_root(tmp_path_factory):
    from gnn_tail_generalization.data.synthetic import (
        write_fake_planetoid_raw,
    )

    root = tmp_path_factory.mktemp("fakedata_pm")
    write_fake_planetoid_raw(str(root), "pubmed", n_node=19717, n_feat=500,
                             n_class=3, n_allx=18717, n_train=60,
                             n_edge_und=44324)
    return str(root)


def _run_teacher_dryrun(root, dataset, n_node, n_feat, **over):
    from gnn_tail_generalization.config import build_config
    from gnn_tail_generalization.data.datasets import (
        load_dataset, prepare,
    )
    from gnn_tail_generalization.train import loops

    # the gather SpMM at every size: the protocol under test does not
    # depend on the aggregation path, and gather is the fast one on CPU
    cfg = build_config(dataset=dataset, train_which="TeacherGNN",
                       want_headtail=True, num_layers=2,
                       use_special_split=True, spmm_method="gather",
                       **over)
    data = load_dataset(cfg, root)
    assert data.name == dataset and data.x.shape == (n_node, n_feat)
    pd = prepare(data, cfg)
    t0 = time.time()
    res = loops.train_teacher(cfg, pd, seed=0, epoch_block=100)
    wall = time.time() - t0
    assert res.records.shape[0] == cfg.epochs
    assert np.isfinite(res.records).all()
    chance = 100.0 / cfg.num_classes
    assert res.best("acc_test") > chance + 5
    print(f"\ngolden dryrun {dataset} SE={over.get('whetherHasSE')}: "
          f"{cfg.epochs} epochs in {wall:.1f}s, "
          f"best acc_test {res.best('acc_test'):.2f}")


@pytest.mark.slow
def test_golden_protocol_dryrun_citeseer_traditional(fake_citeseer_root):
    """readme.md:49 — Citeseer traditional GCN (SE=000): 69.7."""
    _run_teacher_dryrun(fake_citeseer_root, "Citeseer", 3327, 3703,
                        whetherHasSE="000")


@pytest.mark.slow
def test_golden_protocol_dryrun_citeseer_coldbrew(fake_citeseer_root):
    """readme.md:57 — Citeseer CB teacher (SE=100, se_reg=0.5): 71.40."""
    _run_teacher_dryrun(fake_citeseer_root, "Citeseer", 3327, 3703,
                        whetherHasSE="100", se_reg=0.5)


@pytest.mark.slow
def test_golden_protocol_dryrun_pubmed_traditional(fake_pubmed_root):
    """readme.md:51 — Pubmed traditional GCN (SE=000): 78.2."""
    _run_teacher_dryrun(fake_pubmed_root, "Pubmed", 19717, 500,
                        whetherHasSE="000")


@pytest.mark.slow
def test_golden_protocol_dryrun_pubmed_coldbrew(fake_pubmed_root):
    """readme.md:59 — Pubmed CB teacher (SE=111, se_reg=0.5): 78.2."""
    _run_teacher_dryrun(fake_pubmed_root, "Pubmed", 19717, 500,
                        whetherHasSE="111", se_reg=0.5)


def _run_student_dryrun(fake_cora_root, train_which):
    from gnn_tail_generalization.config import build_config
    from gnn_tail_generalization.data.datasets import (
        load_dataset, prepare,
    )
    from gnn_tail_generalization.train import loops

    cfg = build_config(dataset="Cora", train_which=train_which,
                       want_headtail=True, use_special_split=True)
    data = load_dataset(cfg, fake_cora_root)
    assert data.name == "Cora"
    pd = prepare(data, cfg)
    t0 = time.time()
    res = loops.run_experiment(cfg, pd, seed=0, epoch_block=100)
    wall = time.time() - t0
    assert "iso" in res.columns
    assert np.isfinite(res.records).all()
    print(f"\ngolden dryrun {train_which}: {wall:.1f}s, "
          f"best iso {res.best('iso'):.2f}")


@pytest.mark.slow
def test_golden_protocol_dryrun_studentbasemlp(fake_cora_root):
    """readme.md:65 — naive MLP (StudentBaseMLP), isolation 61.80."""
    _run_student_dryrun(fake_cora_root, "StudentBaseMLP")


@pytest.mark.slow
def test_golden_protocol_dryrun_graphmlp(fake_cora_root):
    """readme.md:69 — GraphMLP, isolation 68.63."""
    _run_student_dryrun(fake_cora_root, "GraphMLP")


@pytest.mark.slow
def test_golden_protocol_dryrun_arxiv_best_config(tmp_path_factory):
    """base_options.py:412 — ogbn-arxiv best-config teacher (71.54) at
    real dims (169343 x 128) through the real OGB CSV loader on a
    generated fake raw set. Trains a SHORT run (50 epochs, block 25) —
    the full 1500-epoch protocol at arxiv scale is a bench-length GPU
    job, not a CPU test; the data-drop-day surface under test is the
    loader + best-config pipeline + full-size training step."""
    from gnn_tail_generalization.config import build_config
    from gnn_tail_generalization.data.datasets import (
        load_dataset, prepare,
    )
    from gnn_tail_generalization.data.synthetic import (
        write_fake_ogbn_arxiv_raw,
    )
    from gnn_tail_generalization.train import loops

    root = tmp_path_factory.mktemp("fakedata_arxiv")
    t0 = time.time()
    write_fake_ogbn_arxiv_raw(str(root))
    t_write = time.time() - t0

    # the gather SpMM, as at every size above the dense threshold
    cfg = build_config(dataset="ogbn-arxiv", train_which="TeacherGNN",
                       force_set_to_best_config=True, epochs=50,
                       spmm_method="gather")
    t0 = time.time()
    data = load_dataset(cfg, str(root))
    t_load = time.time() - t0
    assert data.name == "ogbn-arxiv"
    assert data.x.shape == (169343, 128)
    assert int(data.train_mask.sum()) == 90941
    pd = prepare(data, cfg)
    t0 = time.time()
    res = loops.train_teacher(cfg, pd, seed=0, epoch_block=25)
    wall = time.time() - t0
    assert np.isfinite(res.records).all()
    assert res.best("acc_test") > 100.0 / 40 + 3
    print(f"\ngolden dryrun arxiv best-config: write {t_write:.1f}s "
          f"load {t_load:.1f}s train(50ep) {wall:.1f}s, "
          f"best acc_test {res.best('acc_test'):.2f}")
