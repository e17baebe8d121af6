"""2-D (graph x model) mesh training step on the virtual CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp

from gnn_tail_generalization.graph import core
from gnn_tail_generalization.parallel import distributed as dist
from gnn_tail_generalization.parallel import tensor_parallel as tp


def test_2d_train_step_runs_and_learns(rng):
    n, n_feat, n_hidden, n_class = 64, 12, 16, 4
    ei = core.standard_pipeline(
        np.stack([rng.integers(0, n, 300), rng.integers(0, n, 300)]), n
    )
    mesh = tp.make_2d_mesh(4, 2)
    sg = dist.shard_graph(ei, n, 4)

    y = rng.integers(0, n_class, n)
    x = rng.normal(size=(n, n_feat)).astype(np.float32)
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
    bsh = tp.batch_shardings_2d(mesh, batch)
    batch = {k: jax.device_put(jnp.asarray(v), bsh[k])
             for k, v in batch.items()}
    params = tp.init_2d_teacher(jax.random.PRNGKey(0), sg.n_node_pad,
                                n_feat, n_hidden, n_class)
    psh = tp.param_shardings_2d(mesh, params)
    params = {k: jax.device_put(v, psh[k]) for k, v in params.items()}
    step = tp.make_2d_train_step(mesh, lr=0.05, se_reg=0.001)
    losses = []
    for _ in range(12):
        params, loss = step(params, batch, sg)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_param_sharding_specs():
    mesh = tp.make_2d_mesh(4, 2)
    params = tp.init_2d_teacher(jax.random.PRNGKey(0), 64, 8, 16, 4)
    sh = tp.param_shardings_2d(mesh, params)
    from jax.sharding import PartitionSpec as P

    assert sh["se0"].spec == P("graph", "model")
    assert sh["w0"].spec == P(None, "model")
    assert sh["w1"].spec == P("model", None)
