"""Multi-chip sharding on the 8-device virtual CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from gnn_tail_generalization.graph import core
from gnn_tail_generalization.ops.spmm import spmm
from gnn_tail_generalization.parallel import distributed as dist


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def random_graph(rng, n, e):
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    return np.stack([src, dst])


def test_dist_spmm_matches_single_device(rng):
    n, e = 64, 400
    ei = random_graph(rng, n, e)
    mesh = dist.make_graph_mesh(8)
    sg = dist.shard_graph(ei, n, 8)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    xp = dist.pad_rows(x, sg.n_node_pad)
    sh = NamedSharding(mesh, P("graph", None))
    xd = jax.device_put(jnp.asarray(xp), sh)
    y = dist.dist_spmm(mesh, sg, xd)

    g = core.build_graph(ei, n)
    y_ref = spmm(g, jnp.asarray(x), "gather")
    np.testing.assert_allclose(
        np.asarray(y)[:n], np.asarray(y_ref), rtol=1e-4, atol=1e-4
    )


def test_dist_spmm_grad_matches(rng):
    n = 48
    ei = random_graph(rng, n, 300)
    mesh = dist.make_graph_mesh(8)
    sg = dist.shard_graph(ei, n, 8)
    g = core.build_graph(ei, n)
    x = rng.normal(size=(sg.n_node_pad, 8)).astype(np.float32)
    ct = rng.normal(size=(sg.n_node_pad, 8)).astype(np.float32)

    def f_dist(x):
        return jnp.vdot(dist.dist_spmm(mesh, sg, x), jnp.asarray(ct))

    def f_ref(x):
        return jnp.vdot(spmm(g, x[:n], "gather"), jnp.asarray(ct)[:n])

    sh = NamedSharding(mesh, P("graph", None))
    xd = jax.device_put(jnp.asarray(x), sh)
    dx_d = jax.jit(jax.grad(f_dist))(xd)
    dx_r = jax.grad(f_ref)(jnp.asarray(x))
    np.testing.assert_allclose(
        np.asarray(dx_d)[:n], np.asarray(dx_r)[:n], rtol=1e-4, atol=1e-4
    )


def test_dist_train_step_runs_and_learns(rng):
    n, n_feat, n_hidden, n_class = 80, 12, 16, 3
    ei = core.standard_pipeline(random_graph(rng, n, 300), n)
    mesh = dist.make_graph_mesh(8)
    sg = dist.shard_graph(ei, n, 8)

    y = rng.integers(0, n_class, n)
    x = rng.normal(size=(n, n_feat)).astype(np.float32)
    # make features informative
    x[np.arange(n), y] += 2.0
    dout, din = core.degrees(ei, n)
    train_mask = rng.random(n) < 0.5

    batch = {
        "x": dist.pad_rows(x, sg.n_node_pad),
        "y": dist.pad_rows(y.astype(np.int32), sg.n_node_pad),
        "train_mask": dist.pad_rows(train_mask, sg.n_node_pad),
        "deg_in": dist.pad_rows(din, sg.n_node_pad),
        "deg_out": dist.pad_rows(dout, sg.n_node_pad),
    }
    sh = NamedSharding(mesh, P("graph"))
    sh2 = NamedSharding(mesh, P("graph", None))
    batch = {
        k: jax.device_put(jnp.asarray(v), sh2 if v.ndim == 2 else sh)
        for k, v in batch.items()
    }

    params = dist.init_dist_teacher(
        jax.random.PRNGKey(0), sg.n_node_pad, n_feat, n_hidden, n_class,
        has_se=(1, 0),
    )
    shardings = dist.param_shardings(mesh, params)
    params = jax.tree.map(jax.device_put, params, shardings)

    step = dist.make_dist_train_step(mesh, lr=0.05, se_reg=0.01)
    losses = []
    for _ in range(15):
        params, loss = step(params, batch, sg)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    # SE table stayed sharded
    se_shard = params["se0"].sharding
    assert se_shard.spec == P("graph", None)


def test_ring_spmm_matches_single_device(rng):
    n, e = 64, 400
    ei = random_graph(rng, n, e)
    mesh = dist.make_graph_mesh(8)
    rg = dist.shard_graph_ring(ei, n, 8)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    xp = dist.pad_rows(x, rg.n_node_pad)
    sh = NamedSharding(mesh, P("graph", None))
    xd = jax.device_put(jnp.asarray(xp), sh)
    y = jax.jit(lambda x: dist.dist_spmm_ring(mesh, rg, x))(xd)

    g = core.build_graph(ei, n)
    y_ref = spmm(g, jnp.asarray(x), "gather")
    np.testing.assert_allclose(
        np.asarray(y)[:n], np.asarray(y_ref), rtol=1e-4, atol=1e-4
    )


def test_ring_spmm_grad(rng):
    n = 40
    ei = random_graph(rng, n, 250)
    mesh = dist.make_graph_mesh(8)
    rg = dist.shard_graph_ring(ei, n, 8)
    g = core.build_graph(ei, n)
    x = rng.normal(size=(rg.n_node_pad, 8)).astype(np.float32)
    ct = rng.normal(size=(rg.n_node_pad, 8)).astype(np.float32)
    sh = NamedSharding(mesh, P("graph", None))
    xd = jax.device_put(jnp.asarray(x), sh)

    dx = jax.jit(jax.grad(
        lambda x: jnp.vdot(dist.dist_spmm_ring(mesh, rg, x),
                           jnp.asarray(ct))))(xd)
    dx_ref = jax.grad(
        lambda x: jnp.vdot(spmm(g, x[:n], "gather"),
                           jnp.asarray(ct)[:n]))(jnp.asarray(x))
    np.testing.assert_allclose(
        np.asarray(dx)[:n], np.asarray(dx_ref)[:n], rtol=1e-4, atol=1e-4
    )
