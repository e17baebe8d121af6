"""DistGraph: the real model on a mesh (8 virtual CPU devices).

Covers VERDICT round-1 items 2 and 3: the full TricksComb teacher trains
under the mesh with numerics matching single-device, and the sharded
aggregation moves feature blocks only by the ring's collective-permute
(HLO inspected).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gnn_tail_generalization.graph import core
from gnn_tail_generalization.parallel import distgraph as dgm


def _mesh(n=4):
    return jax.make_mesh((n,), ("graph",), devices=jax.devices()[:n])


def _random_graph(rng, n=96, e=500):
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (dst, src), w)
    return np.stack([src, dst]), w, dense


def test_dist_spmm_matches_dense(rng):
    mesh = _mesh(4)
    e, w, dense = _random_graph(rng)
    dg = dgm.build_dist_graph(e, 96, mesh, edge_weight=w, rb=8)
    assert dg.n_node_pad == 96
    x = rng.normal(size=(96, 48)).astype(np.float32)
    y = dgm.dist_spmm(dg, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), dense @ x, rtol=1e-4,
                               atol=1e-4)


def test_dist_spmm_grad_via_spmm_entry(rng):
    """ops.spmm.spmm dispatches DistGraph; its custom VJP must route the
    transposed ring (dx = A^T dy)."""
    from gnn_tail_generalization.ops.spmm import spmm

    mesh = _mesh(4)
    e, w, dense = _random_graph(rng, e=400)
    dg = dgm.build_dist_graph(e, 96, mesh, edge_weight=w, rb=8)
    x = jnp.asarray(rng.normal(size=(96, 32)).astype(np.float32))
    ct = jnp.asarray(rng.normal(size=(96, 32)).astype(np.float32))

    y = spmm(dg, x)
    np.testing.assert_allclose(np.asarray(y), dense @ np.asarray(x),
                               rtol=1e-4, atol=1e-4)
    dx = jax.jit(jax.grad(lambda x: jnp.vdot(spmm(dg, x), ct)))(x)
    np.testing.assert_allclose(np.asarray(dx), dense.T @ np.asarray(ct),
                               rtol=1e-4, atol=1e-4)


def test_dist_graph_padded_rows(rng):
    """n not divisible by shards*rb: padded rows aggregate to zero."""
    mesh = _mesh(4)
    e, w, dense = _random_graph(rng, n=90, e=400)
    dg = dgm.build_dist_graph(e, 90, mesh, edge_weight=w, rb=8)
    assert dg.n_node_pad == 96
    x = rng.normal(size=(90, 16)).astype(np.float32)
    xp = np.concatenate([x, np.zeros((6, 16), np.float32)])
    y = dgm.dist_spmm(dg, jnp.asarray(xp))
    np.testing.assert_allclose(np.asarray(y)[:90], dense @ x, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(y)[90:], 0.0, atol=1e-6)


def _teacher_setup(rng, n=96, n_feat=24, n_class=5, type_trick="Residual"):
    from gnn_tail_generalization.config import (
        apply_arch_configs, build_config,
    )
    from gnn_tail_generalization.data.datasets import NodeData
    from gnn_tail_generalization.data.synthetic import (
        synthetic_features_labels,
    )

    cfg = build_config(dataset="Cora", train_which="SEMLP",
                       whetherHasSE="100", se_reg=0.5)
    cfg = dataclasses.replace(
        cfg, N_nodes=n, num_feats=n_feat, num_classes=n_class, dim_hidden=16,
        dropout=0.0, type_trick=type_trick, use_special_split=True,
        epochs=4,
    )
    cfg = apply_arch_configs(cfg)
    x, y = synthetic_features_labels(n, n_feat, n_class, 0)
    src = rng.integers(0, n, 4 * n)
    dst = rng.integers(0, n, 4 * n)
    train = np.zeros(n, bool)
    train[: n // 2] = True
    data = NodeData(x=x, y=y, edge_index=np.stack([src, dst]),
                    train_mask=train, val_mask=None, test_mask=~train,
                    name="dist-test")
    return cfg, data


def _assert_bn_adam_parity(r1, r2, epochs: int, lr: float):
    """Sharded vs single-device parity for the BatchNorm teacher under Adam.

    The conv bias ahead of a BatchNorm has a zero true gradient, so its
    computed gradient is rounding noise, and the row-sharded reductions
    of the mesh round differently from the single-device ones. Adam
    normalizes that noise into steps of up to ``lr``, and eval-mode
    BatchNorm (running mean) passes the bias through, which can flip a
    node near the decision boundary. Everything the noise cannot move
    must still match: the training-mode loss (training-mode BatchNorm
    subtracts the bias again), every other parameter, the running
    variances, and the biases may differ by no more than Adam's steps."""
    col = r1.columns.index("loss_train")
    np.testing.assert_allclose(r2.records[:, col], r1.records[:, col],
                               rtol=1e-4, atol=1e-3)
    flat2 = dict(jax.tree_util.tree_flatten_with_path(r2.variables)[0])
    n_checked = 0
    for path, a in jax.tree_util.tree_flatten_with_path(r1.variables)[0]:
        keys = [p.key for p in path]
        a, b = np.asarray(a), np.asarray(flat2[path])[: np.shape(a)[0]]
        if keys[-1] == "bias" and keys[-2].startswith("conv_"):
            assert np.abs(a - b).max() <= 2 * epochs * lr, keys
        elif keys[0] == "batch_stats" and keys[-1] == "mean":
            continue  # the running mean carries the conv bias
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5,
                                       err_msg=str(keys))
            n_checked += 1
    assert n_checked >= 6


@pytest.mark.parametrize("n,trick,optfun", [
    pytest.param(96, "Residual", "adam", id="96-Residual"),
    pytest.param(90, "NodeNorm", "adam", id="90-NodeNorm"),
    pytest.param(96, "BatchNorm", "adam", id="96-BatchNorm"),
    pytest.param(96, "BatchNorm", "sgd", id="96-BatchNorm-sgd"),
])
def test_full_teacher_sharded_matches_single_device(rng, n, trick, optfun):
    """The REAL TricksComb teacher (tricks, norms, SE, Adam, head/tail/iso
    eval) trained on the mesh must reproduce the single-device records —
    including keep_best checkpointing and the n=90 padded-row case. Under
    SGD the BatchNorm teacher's zero-gradient conv bias passes its noise
    through unamplified, so every record must match there too."""
    from gnn_tail_generalization.data.datasets import (
        prepare, prepare_sharded,
    )
    from gnn_tail_generalization.train import loops

    cfg, data = _teacher_setup(rng, n=n, type_trick=trick)
    cfg = dataclasses.replace(cfg, optfun=optfun)
    pd_single = prepare(data, cfg)
    r1 = loops.train_teacher(cfg, pd_single, seed=3, epochs=4)

    mesh = _mesh(4)
    pd_dist = prepare_sharded(data, cfg, mesh, rb=8)
    r2 = loops.train_teacher(cfg, pd_dist, seed=3, epochs=4)

    assert r1.columns == r2.columns
    if trick == "BatchNorm" and optfun == "adam":
        _assert_bn_adam_parity(r1, r2, epochs=4, lr=cfg.lr)
    else:
        np.testing.assert_allclose(r2.records, r1.records, rtol=1e-4,
                                   atol=1e-3)


def _assert_ring_only_collectives(hlo: str):
    """The sharded SpMM's only cross-device traffic is the ring: blocks
    move by collective-permute, never by an all-gather or all-to-all of
    the feature table."""
    assert "collective-permute" in hlo
    assert "all-gather" not in hlo and "all-to-all" not in hlo


def test_sharded_path_emits_no_scatter(rng):
    """A full loss+grad step over the mesh, checked on its compiled HLO:
    the ring's collective-permute is the only cross-device traffic (each
    device's reduction is a local segment_sum)."""
    mesh = _mesh(4)
    e, w, _ = _random_graph(rng, e=400)
    dg = dgm.build_dist_graph(e, 96, mesh, edge_weight=w, rb=8)
    x = jnp.asarray(rng.normal(size=(96, 32)).astype(np.float32))

    from gnn_tail_generalization.ops.spmm import spmm

    def loss(x, dg):
        return jnp.sum(spmm(dg, x) ** 2)

    hlo = jax.jit(jax.grad(loss)).lower(x, dg).compile().as_text()
    _assert_ring_only_collectives(hlo)


@pytest.mark.slow
def test_dryrun_multichip_runs_real_model():
    import importlib
    import sys

    sys.path.insert(0, "/root/repo")
    ge = importlib.import_module("__graft_entry__")
    ge.dryrun_multichip(8)


def test_sharded_training_checkpoints_roundtrip(rng, tmp_path):
    """Sharded teacher params (SE row-sharded over the mesh) must save and
    reload through the .npz checkpointer."""
    from gnn_tail_generalization.data.datasets import prepare_sharded
    from gnn_tail_generalization.train import loops
    from gnn_tail_generalization.train.checkpoint import (
        load_train_state, save_train_state,
    )

    cfg, data = _teacher_setup(rng, n=96)
    mesh = _mesh(4)
    pd = prepare_sharded(data, cfg, mesh, rb=8)
    res = loops.train_teacher(cfg, pd, seed=0, epochs=2)

    path = str(tmp_path / "teacher.npz")
    save_train_state(path, params=res.variables["params"], epoch=2)
    loaded = load_train_state(path, {"params": res.variables["params"],
                                     "epoch": 0})
    for a, b in zip(jax.tree.leaves(res.variables["params"]),
                    jax.tree.leaves(loaded["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_masked_dist_spmm_matches_dense(rng):
    """masked_dist_graph: a per-edge mask over the canonical (dst-sorted)
    global edge order must scale both weight arrays consistently — fwd and
    transposed bucket slots — and recompute degrees."""
    mesh = _mesh(4)
    e, w, _ = _random_graph(rng, e=500)
    dg = dgm.build_dist_graph(e, 96, mesh, edge_weight=w, rb=8,
                              with_edge_view=True)
    # canonical order replicates the builder's sort
    can = np.lexsort((e[0], e[1]))
    ec, wc = e[:, can], w[can]
    mask = (rng.random(e.shape[1]) < 0.6).astype(np.float32)
    dense_m = np.zeros((96, 96), np.float32)
    np.add.at(dense_m, (ec[1], ec[0]), wc * mask)

    # gid alignment: every bucket slot's weight equals the canonical edge
    # weight its gid points to (pad slots: gid -1, weight 0)
    for warr, garr in ((dg.bkt_weight, dg.bkt_gid),
                       (dg.bkt_weight_t, dg.bkt_gid_t)):
        wn, gn = np.asarray(warr).ravel(), np.asarray(garr).ravel()
        np.testing.assert_allclose(wn[gn >= 0], wc[gn[gn >= 0]])
        np.testing.assert_allclose(wn[gn < 0], 0.0)

    gm = jax.jit(dgm.masked_dist_graph)(dg, jnp.asarray(mask))
    x = jnp.asarray(rng.normal(size=(96, 32)).astype(np.float32))
    y = dgm.dist_spmm(gm, x)
    np.testing.assert_allclose(np.asarray(y), dense_m @ np.asarray(x),
                               rtol=1e-4, atol=1e-4)
    # transposed path (the backward ring) sees the SAME mask
    yt = dgm.dist_spmm(gm.transpose(), x)
    np.testing.assert_allclose(np.asarray(yt), dense_m.T @ np.asarray(x),
                               rtol=1e-4, atol=1e-4)
    # degrees recomputed from surviving edges (sorted segment sums)
    keep = mask * (wc != 0)
    np.testing.assert_allclose(
        np.asarray(gm.deg_in)[:96],
        np.bincount(ec[1], weights=keep, minlength=96))
    np.testing.assert_allclose(
        np.asarray(gm.deg_out)[:96],
        np.bincount(ec[0], weights=keep, minlength=96))


def test_graph_dropout_dropnode_dist_matches_single_device(rng):
    """DropNode draws a node mask (same shape single-device and sharded),
    so the full teacher under apply_graph_dropout must produce identical
    records on the mesh — the strong parity check for sharded dropout."""
    from gnn_tail_generalization.data.datasets import (
        prepare, prepare_sharded,
    )
    from gnn_tail_generalization.train import loops

    cfg, data = _teacher_setup(rng, n=96, type_trick="Residual+DropNode")
    cfg = dataclasses.replace(cfg, apply_graph_dropout=True,
                              graph_dropout=0.4)
    pd_single = prepare(data, cfg)
    r1 = loops.train_teacher(cfg, pd_single, seed=3, epochs=3)

    mesh = _mesh(4)
    pd_dist = prepare_sharded(data, cfg, mesh, rb=8)
    assert pd_dist.graph.has_edge_view
    r2 = loops.train_teacher(cfg, pd_dist, seed=3, epochs=3)
    np.testing.assert_allclose(r2.records, r1.records, rtol=1e-4, atol=1e-3)


def test_graph_dropout_dropedge_dist_trains(rng):
    """DropEdge's per-edge draw can't match single-device edge order;
    smoke: the sharded teacher trains finite, and the masked step keeps
    the ring as its only cross-device traffic."""
    from gnn_tail_generalization.data.datasets import prepare_sharded
    from gnn_tail_generalization.train import loops
    from gnn_tail_generalization.ops.spmm import spmm

    cfg, data = _teacher_setup(rng, n=96, type_trick="Residual+DropEdge")
    cfg = dataclasses.replace(cfg, apply_graph_dropout=True,
                              graph_dropout=0.5)
    mesh = _mesh(4)
    pd = prepare_sharded(data, cfg, mesh, rb=8)
    res = loops.train_teacher(cfg, pd, seed=0, epochs=2)
    assert np.isfinite(res.records).all()

    dg = pd.graph
    mask = jnp.asarray(
        (rng.random(np.asarray(dg.edge_w).shape[0]) < 0.5).astype(
            np.float32))
    x = jnp.asarray(rng.normal(size=(dg.n_node_pad, 32)).astype(np.float32))

    def loss(x, dg, mask):
        gm = dgm.masked_dist_graph(dg, mask)
        return jnp.sum(spmm(gm, x) ** 2)

    hlo = jax.jit(jax.grad(loss)).lower(x, dg, mask).compile().as_text()
    _assert_ring_only_collectives(hlo)


def test_sharded_orbax_checkpoint_roundtrip(rng, tmp_path):
    """Orbax sharded save/restore: values survive, restored leaves land on
    the shardings the template asks for — including DIFFERENT shardings
    than at save time (reshard-on-load)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gnn_tail_generalization.parallel.distgraph import shard_params
    from gnn_tail_generalization.train.checkpoint import (
        load_sharded_state, save_sharded_state,
    )

    mesh = _mesh(4)
    params = {
        "layer0": {"kernel": jnp.asarray(
            rng.normal(size=(24, 16)).astype(np.float32)),
            "se": jnp.asarray(rng.normal(size=(96, 16)).astype(np.float32))},
        "head": {"kernel": jnp.asarray(
            rng.normal(size=(16, 5)).astype(np.float32))},
    }
    sharded = shard_params(mesh, params)
    state = {"params": sharded, "epoch": 7}
    path = str(tmp_path / "ckpt")
    save_sharded_state(path, state)

    restored = load_sharded_state(path, state)
    assert restored["epoch"] == 7
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(
            restored["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    se = restored["params"]["layer0"]["se"]
    assert se.sharding.spec == P("graph", None) or se.sharding.spec == P(
        "graph")

    # reshard-on-load: ask for everything replicated
    repl = jax.tree.map(
        lambda x: (x if isinstance(x, int)
                   else jax.ShapeDtypeStruct(
                       x.shape, x.dtype,
                       sharding=NamedSharding(mesh, P()))),
        state)
    restored2 = load_sharded_state(path, repl)
    se2 = restored2["params"]["layer0"]["se"]
    assert se2.sharding.is_fully_replicated
    np.testing.assert_array_equal(np.asarray(se2),
                                  np.asarray(params["layer0"]["se"]))


def test_save_train_state_sharded_routing(rng, tmp_path):
    """save_train_state(sharded=True) writes the orbax directory instead of
    one file, and load_train_state finds it transparently from the same
    path (the auto-route multi-host runs take)."""
    import os

    from gnn_tail_generalization.parallel.distgraph import shard_params
    from gnn_tail_generalization.train.checkpoint import (
        load_train_state, save_train_state,
    )

    mesh = _mesh(4)
    params = {"se": jnp.asarray(rng.normal(size=(32, 8)).astype(np.float32))}
    sharded = shard_params(mesh, params)
    path = str(tmp_path / "teacher.npz")
    save_train_state(path, params=sharded, epoch=3, sharded=True)
    assert not os.path.exists(path)
    assert os.path.isdir(str(tmp_path / "teacher.orbax"))
    loaded = load_train_state(path, {"params": sharded, "epoch": 0})
    assert loaded["epoch"] == 3
    np.testing.assert_array_equal(np.asarray(loaded["params"]["se"]),
                                  np.asarray(params["se"]))


def test_train_state_format_collision_newest_wins(rng, tmp_path):
    """When a single-file save and an orbax dir share a path stem: a sharded
    save removes the stale file, a later single-file save wins by being
    newer, and a further sharded save force-overwrites the existing orbax
    dir — load_train_state always restores the newest state."""
    import os
    import time

    from gnn_tail_generalization.parallel.distgraph import shard_params
    from gnn_tail_generalization.train.checkpoint import (
        load_train_state, save_train_state,
    )

    mesh = _mesh(4)
    path = str(tmp_path / "t.npz")

    def params(seed):
        return {"se": jnp.asarray(
            np.random.default_rng(seed).normal(size=(16, 4)).astype(
                np.float32))}

    tmpl = {"params": params(0), "epoch": 0}
    save_train_state(path, params=params(1), epoch=1, sharded=False)
    save_train_state(path, params=shard_params(mesh, params(2)), epoch=2,
                     sharded=True)
    assert not os.path.exists(path)  # stale file removed
    assert load_train_state(path, tmpl)["epoch"] == 2

    time.sleep(0.05)  # mtime separation on coarse filesystems
    save_train_state(path, params=params(3), epoch=3, sharded=False)
    loaded = load_train_state(path, tmpl)  # newer file beats orbax dir
    assert loaded["epoch"] == 3
    np.testing.assert_array_equal(np.asarray(loaded["params"]["se"]),
                                  np.asarray(params(3)["se"]))

    save_train_state(path, params=shard_params(mesh, params(4)), epoch=4,
                     sharded=True)  # force-overwrites the existing dir
    assert load_train_state(path, tmpl)["epoch"] == 4


def test_dist_spmm_bf16_packed_ring(rng):
    """compute_dtype=bfloat16 streams and gathers bf16 blocks with f32
    sums; tolerance vs dense at bf16 operands."""
    mesh = _mesh(4)
    e, w, dense = _random_graph(rng, e=400)
    dg = dgm.build_dist_graph(e, 96, mesh, edge_weight=w, rb=8)
    x = rng.normal(size=(96, 256)).astype(np.float32)
    y = dgm.dist_spmm(dg, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(np.asarray(y), dense @ xb, rtol=3e-2,
                               atol=3e-2)


def test_full_teacher_2d_mesh_matches_single_device(rng):
    """2-D (graph x model) mesh: activations/SE feature-sharded over the
    model axis, kernels column-parallel — the real teacher still matches
    single-device records."""
    from gnn_tail_generalization.data.datasets import (
        prepare, prepare_sharded,
    )
    from gnn_tail_generalization.train import loops

    cfg, data = _teacher_setup(rng, n=96)
    pd_single = prepare(data, cfg)
    r1 = loops.train_teacher(cfg, pd_single, seed=3, epochs=3)

    mesh = jax.make_mesh((4, 2), ("graph", "model"),
                         devices=jax.devices()[:8])
    pd_dist = prepare_sharded(data, cfg, mesh, model_axis="model",
                              rb=8)
    r2 = loops.train_teacher(cfg, pd_dist, seed=3, epochs=3)

    assert r1.columns == r2.columns
    np.testing.assert_allclose(r2.records, r1.records, rtol=1e-4, atol=1e-3)


def test_dist_spmm_2d_mesh(rng):
    mesh = jax.make_mesh((4, 2), ("graph", "model"),
                         devices=jax.devices()[:8])
    e, w, dense = _random_graph(rng)
    dg = dgm.build_dist_graph(e, 96, mesh, edge_weight=w,
                              model_axis="model", rb=8)
    x = rng.normal(size=(96, 48)).astype(np.float32)
    xg = dgm.global_put(
        x, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("graph", "model")))
    y = dgm.dist_spmm(dg, xg)
    np.testing.assert_allclose(np.asarray(y), dense @ x, rtol=1e-4,
                               atol=1e-4)


def test_edgewise_loss_sharded_matches_single_device(rng):
    """VERDICT r2 weak #3: the edgewise (I2_GTL) auxiliary loss under a
    DistGraph — DistMult pair rows assembled via one psum
    (dist_take_rows) — must reproduce the single-device records."""
    from gnn_tail_generalization.data.datasets import (
        prepare, prepare_sharded,
    )
    from gnn_tail_generalization.train import loops

    cfg, data = _teacher_setup(rng, n=96, type_trick="Residual")
    cfg = dataclasses.replace(
        cfg, has_loss_component_edgewise=True, samp_size_p=16,
        samp_size_n_train=16, samp_size_n_test_times_p=2)
    pd_single = prepare(data, cfg)
    r1 = loops.train_teacher(cfg, pd_single, seed=3, epochs=3)
    assert "linkp_train" in r1.columns

    mesh = _mesh(4)
    pd_dist = prepare_sharded(data, cfg, mesh, rb=8)
    r2 = loops.train_teacher(cfg, pd_dist, seed=3, epochs=3)

    assert r1.columns == r2.columns
    np.testing.assert_allclose(r2.records, r1.records, rtol=1e-4, atol=1e-3)


def test_dist_take_rows(rng):
    """Replicated few-row gather from a row-sharded array (one psum)."""
    mesh = _mesh(4)
    from jax.sharding import NamedSharding, PartitionSpec as P

    n, d = 64, 8
    h = rng.normal(size=(n, d)).astype(np.float32)
    g = dgm.build_dist_graph(np.stack([np.arange(n), np.arange(n)]), n,
                             mesh, rb=8)
    hd = jax.device_put(h, NamedSharding(mesh, P("graph", None)))
    idx = np.asarray([0, 5, 17, 63, 33, 33], np.int32)
    out = jax.jit(lambda h, i: dgm.dist_take_rows(g, h, i))(
        hd, jnp.asarray(idx))
    np.testing.assert_allclose(np.asarray(out), h[idx], rtol=1e-6)


@pytest.mark.slow
def test_edgewise_loss_2d_mesh_matches_single_device(rng):
    """Edgewise under a (graph x model) 2-D mesh: dist_take_rows keeps the
    feature dim sharded over the model axis; the DistMult scores must
    still match single-device."""
    from gnn_tail_generalization.data.datasets import (
        prepare, prepare_sharded,
    )
    from gnn_tail_generalization.train import loops

    cfg, data = _teacher_setup(rng, n=96, type_trick="Residual")
    cfg = dataclasses.replace(
        cfg, has_loss_component_edgewise=True, samp_size_p=16,
        samp_size_n_train=16, samp_size_n_test_times_p=2)
    pd_single = prepare(data, cfg)
    r1 = loops.train_teacher(cfg, pd_single, seed=3, epochs=2)

    mesh2d = jax.make_mesh((4, 2), ("graph", "model"))
    pd_dist = prepare_sharded(data, cfg, mesh2d, model_axis="model",
                              rb=8)
    r2 = loops.train_teacher(cfg, pd_dist, seed=3, epochs=2)
    assert r1.columns == r2.columns
    np.testing.assert_allclose(r2.records, r1.records, rtol=1e-4, atol=1e-3)


@pytest.mark.slow
def test_masked_final_layer_dist_padded_rows(rng):
    """The loss-masked final-layer DistGraph view with a padded row count
    (n=90 on a 4-shard rb=8 mesh -> n_node_pad=96) must reproduce the
    single-device records, and turning the optimization off must too."""
    from gnn_tail_generalization.data.datasets import (
        prepare, prepare_sharded,
    )
    from gnn_tail_generalization.train import loops

    cfg, data = _teacher_setup(rng, n=90, type_trick="Residual")
    pd_single = prepare(data, cfg)
    r1 = loops.train_teacher(cfg, pd_single, seed=3, epochs=3)

    mesh = _mesh(4)
    pd_dist = prepare_sharded(data, cfg, mesh, rb=8)
    # gate must be active for this config
    assert loops.final_agg_view(cfg, pd_dist, is_dist=True) is not None
    r2 = loops.train_teacher(cfg, pd_dist, seed=3, epochs=3)
    np.testing.assert_allclose(r2.records, r1.records, rtol=1e-4, atol=1e-3)

    cfg_off = dataclasses.replace(cfg, optimize_final_layer_agg=False)
    r3 = loops.train_teacher(cfg_off, pd_dist, seed=3, epochs=3)
    np.testing.assert_allclose(r3.records, r1.records, rtol=1e-4, atol=1e-3)


# --- round 4: the REST of the pipeline sharded (SEMLP / students / LP) ----


def test_semlp_full_pipeline_sharded_matches_single_device(rng):
    """run_experiment('SEMLP') on prepare_sharded data — teacher, SE
    collection, part-1 distillation, part-2 latent-neighbor attention
    (psum-merged per-shard top-k) — must reproduce the single-device
    records (VERDICT r3 item 3)."""
    from gnn_tail_generalization.data.datasets import (
        prepare, prepare_sharded,
    )
    from gnn_tail_generalization.train import loops

    cfg, data = _teacher_setup(rng, n=90)
    cfg = dataclasses.replace(cfg, dropout_MLP=0.0, batch_size=40,
                              SEMLP_topK_2_replace=3)
    r1 = loops.run_experiment(cfg, prepare(data, cfg), seed=5, epochs=3)

    mesh = _mesh(4)
    pd = prepare_sharded(data, cfg, mesh, rb=8)
    r2 = loops.run_experiment(cfg, pd, seed=5, epochs=3)

    assert r1.columns == r2.columns
    np.testing.assert_allclose(r2.records, r1.records, rtol=1e-4, atol=1e-3)
    # the part-1 phase must match too (distillation against the sharded
    # SE table)
    np.testing.assert_allclose(
        r2.extra["part1"].records, r1.extra["part1"].records,
        rtol=1e-4, atol=1e-3)


def test_dist_latent_replace_matches_single_device(rng):
    """The sharded top-k latent-neighbor op == the batched single-device op
    on the same table (exact scores, psum-merged selection)."""
    import jax.numpy as jnp

    from gnn_tail_generalization.ops.topk_attention import (
        latent_neighbor_replace, make_dist_latent_replace,
    )

    mesh = _mesh(4)
    n_pad, n_valid, d, b, k = 64, 57, 12, 9, 4
    se = rng.normal(size=(n_pad, d)).astype(np.float32)
    se[n_valid:] = 7.7  # poison padding rows: masked out by n_valid
    le = rng.normal(size=(b, d)).astype(np.float32)
    ref = latent_neighbor_replace(jnp.asarray(le),
                                  jnp.asarray(se[:n_valid]), k)
    fn = make_dist_latent_replace(mesh, "graph", n_pad // 4, n_valid)
    se_sh = jax.device_put(
        jnp.asarray(se),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("graph")))
    out = jax.jit(lambda le_, se_: fn(le_, se_, k))(jnp.asarray(le), se_sh)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_students_and_pure_lp_sharded_match_single_device(rng):
    """StudentBaseMLP / GraphMLP / pure label propagation on a mesh match
    single-device (VERDICT r3 item 4: the rest of the dispatch)."""
    from gnn_tail_generalization.data.datasets import (
        prepare, prepare_sharded,
    )
    from gnn_tail_generalization.train import loops

    mesh = _mesh(4)
    for which in ("StudentBaseMLP", "GraphMLP", "LP"):
        cfg, data = _teacher_setup(rng, n=90)
        cfg = dataclasses.replace(cfg, train_which=which, dropout_MLP=0.0,
                                  batch_size=40)
        r1 = loops.run_experiment(cfg, prepare(data, cfg), seed=2, epochs=3)
        pd = prepare_sharded(data, cfg, mesh, rb=8)
        r2 = loops.run_experiment(cfg, pd, seed=2, epochs=3)
        if which == "LP":
            assert r1 == r2, (r1, r2)
        else:
            np.testing.assert_allclose(r2.records, r1.records, rtol=1e-4,
                                       atol=1e-3)


def test_linkpred_sharded_matches_single_device(rng):
    """train_linkpred(mesh=...) — DistGraph encode, psum endpoint gathers —
    reproduces the single-device stats (identical RNG chain; ring-sum
    reassociation within tolerance)."""
    from gnn_tail_generalization.linkpred.model import (
        LinkPredConfig, train_linkpred,
    )

    n, m = 90, 700
    e = np.unique(rng.integers(0, n, (2, m)), axis=1)
    e = e[:, e[0] != e[1]]
    x = rng.normal(size=(n, 12)).astype(np.float32)
    cfg = LinkPredConfig(encoder="SAGE", predictor="DOT", dropout=0.0,
                         use_node_feats=True, train_node_emb=False,
                         eval_metric="mrr", batch_size=64, num_neg=2)
    r1 = train_linkpred(cfg, x, e, n, epochs=2, runs=1, seed=11)
    mesh = _mesh(4)
    r2 = train_linkpred(cfg, x, e, n, epochs=2, runs=1, seed=11,
                        mesh=mesh, dist_rb=8)
    for k in ("valid_mean", "test_mean"):
        np.testing.assert_allclose(r2["stats"][k], r1["stats"][k],
                                   rtol=1e-4)


def test_cs_double_correlation_sharded_matches_single_device(rng):
    """Correct & Smooth's double_correlation stages on DistGraph DAD/AD
    adjacencies == the single-device graphs (the scatter-free masked
    forms are shape-agnostic; dist rows run padded)."""
    import jax.numpy as jnp

    from gnn_tail_generalization.propagation import correlation as corr

    n = 90
    e = np.stack([rng.integers(0, n, 500), rng.integers(0, n, 500)])
    e = e[:, e[0] != e[1]]
    y = rng.integers(0, 5, n)
    model_out = rng.random((n, 5)).astype(np.float32)
    model_out /= model_out.sum(1, keepdims=True)
    label_idx = np.unique(rng.integers(0, n, 30))

    dad, _, ad = corr.gen_normalized_adjs(e, n)
    mesh = _mesh(4)
    dadd = corr.gen_normalized_dist_adj(e, n, mesh, "DAD", rb=8)
    add = corr.gen_normalized_dist_adj(e, n, mesh, "AD", rb=8)
    npad = dadd.n_node_pad

    for fn in (corr.double_correlation_autoscale,
               corr.double_correlation_fixed):
        res1, out1 = jax.jit(lambda yy, mo, li: fn(
            yy, mo, li, li, dad, 0.8, 10, ad, 0.7, 10, 5))(
            jnp.asarray(y), jnp.asarray(model_out), jnp.asarray(label_idx))
        y_p = np.zeros(npad, np.int64)
        y_p[:n] = y
        mo_p = np.zeros((npad, 5), np.float32)
        mo_p[:n] = model_out
        res2, out2 = jax.jit(lambda yy, mo, li: fn(
            yy, mo, li, li, dadd, 0.8, 10, add, 0.7, 10, 5))(
            jnp.asarray(y_p), jnp.asarray(mo_p), jnp.asarray(label_idx))
        np.testing.assert_allclose(np.asarray(out2)[:n], np.asarray(out1),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(res2)[:n], np.asarray(res1),
                                   rtol=1e-4, atol=1e-5)


def test_comm_volume_stats_power_law():
    """Ring volume accounting vs the partition halo lower bound on
    power-law graphs at 2/4/8 shards (VERDICT r4 next #4): the halo bound
    must never exceed the ring volume, the ring's overhead must stay
    bounded (hubs are needed by every shard, so block streaming is near
    the bound at small S), and the numbers must be exact on a hand-built
    case."""
    from gnn_tail_generalization.data.synthetic import (
        fast_powerlaw_graph,
    )
    from gnn_tail_generalization.graph.core import symmetrize

    n = 4096
    e = symmetrize(fast_powerlaw_graph(n, 20_000, 3), n)
    for s in (2, 4, 8):
        st = dgm.comm_volume_stats(e, n, s, rb=8)
        assert st["halo_rows_lower_bound"] <= st["ring_rows_per_spmm"]
        assert st["ring_over_halo"] < 3.0, st  # power-law: near the bound
        assert st["halo_rows_max_dst_shard"] * s >= (
            st["halo_rows_lower_bound"])  # max >= mean

    # exact hand case: 4 nodes, 2 shards, edges 0->2, 0->3, 1->2 (dst
    # shard 1, src shard 0: unique senders {0, 1}) and 2->0 (dst shard 0,
    # src shard 1: unique {2}) -> halo = 3 rows
    e2 = np.array([[0, 0, 1, 2], [2, 3, 2, 0]])
    st = dgm.comm_volume_stats(e2, 4, 2, rb=2)
    assert st["halo_rows_lower_bound"] == 3
    assert st["n_node_pad"] == 4 and st["rows_per_shard"] == 2
    assert st["ring_rows_per_spmm"] == 4  # (S-1) * n_node_pad
    assert st["ring_bytes_per_spmm"] == 4 * 128 * 4
