"""Aux subsystems: checkpointing, NaN guards, determinism, throughput counter."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gnn_tail_generalization.config import build_config
from gnn_tail_generalization.data.datasets import prepare
from gnn_tail_generalization.data.synthetic import synthetic_planetoid
from gnn_tail_generalization.graph import core
from gnn_tail_generalization.train import checkpoint, loops
from gnn_tail_generalization.utils import debug


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "params": {"w": jnp.arange(6.0).reshape(2, 3),
                   "b": jnp.zeros(3)},
        "epoch": 7,
    }
    p = str(tmp_path / "ckpt.npz")
    checkpoint.save_pytree(state, p)
    template = jax.tree.map(jnp.zeros_like, state["params"])
    restored = checkpoint.load_pytree({"params": template, "epoch": 0}, p)
    np.testing.assert_array_equal(np.asarray(restored["params"]["w"]),
                                  state["params"]["w"])
    assert restored["epoch"] == 7


def test_assert_finite_catches_nan():
    debug.assert_finite({"a": jnp.ones(3)})
    with pytest.raises(FloatingPointError):
        debug.assert_finite({"a": jnp.asarray([1.0, np.nan])})


def test_checked_flags_nan():
    err, out = debug.checked(lambda x: jnp.log(x))(jnp.asarray(-1.0))
    assert err.get() is not None  # nan produced


def test_training_is_deterministic():
    cfg = build_config(dataset="Cora", train_which="TeacherGNN")
    cfg = dataclasses.replace(cfg, N_nodes=150, num_feats=30, num_classes=3)
    data = synthetic_planetoid(n_node=150, n_feat=30, n_class=3, seed=0,
                               name="det")
    pd = prepare(data, cfg)
    r1 = loops.train_teacher(cfg, pd, seed=5, epochs=5)
    r2 = loops.train_teacher(cfg, pd, seed=5, epochs=5)
    np.testing.assert_allclose(r1.records, r2.records, rtol=1e-6)
    r3 = loops.train_teacher(cfg, pd, seed=6, epochs=5)
    assert not np.allclose(r1.records, r3.records)


def test_spmm_edges_per_sec_positive(rng):
    e = core.standard_pipeline(
        np.stack([rng.integers(0, 64, 200), rng.integers(0, 64, 200)]), 64)
    g = core.build_graph(e, 64)
    x = jnp.asarray(rng.normal(size=(64, 8)).astype(np.float32))
    eps = debug.spmm_edges_per_sec(g, x, iters=2)
    assert eps > 0


def test_plot_curve_writes_png(tmp_path):
    from gnn_tail_generalization.utils.records import plot_curve

    curve = np.sin(np.linspace(0, 6, 200)) + np.random.default_rng(0).normal(
        0, 0.1, 200)
    p = plot_curve(curve, "loss_train", str(tmp_path), smooth_window=10)
    import os

    assert os.path.exists(p) and os.path.getsize(p) > 1000


def test_tensorrex_grid_grows_across_cells(tmp_path):
    """main.py --prog per-cell resumption: a second cell with larger
    coordinates must grow the shared grid instead of asserting (round-2
    review finding)."""
    from gnn_tail_generalization.utils.records import TensorRex

    path = str(tmp_path / "rex.npy")
    r1 = TensorRex(path, grid_shape=(1, 1), record_len=3, grow_to_fit=True)
    r1.record((0, 0), [1.0, 2.0, 3.0])
    r2 = TensorRex(path, grid_shape=(1, 2), record_len=3, grow_to_fit=True)
    assert not r2.is_done((0, 1))
    assert r2.is_done((0, 0))
    r2.record((0, 1), [4.0, 5.0, 6.0])
    r3 = TensorRex(path, grid_shape=(2, 2), record_len=3, grow_to_fit=True)
    assert r3.is_done((0, 0)) and r3.is_done((0, 1))
    assert not r3.is_done((1, 1))
