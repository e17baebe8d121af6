"""2-D (graph x model) parallel training step.

Extends parallel/distributed.py's 1-D dst-row graph partition with a model
axis for tensor parallelism over feature dimensions:

- mesh ('graph', 'model')
- node features x: row-sharded over 'graph', replicated over 'model'
- W0 [feat, hidden]: column-sharded over 'model' (Megatron column parallel)
- SE table E0 [N, hidden]: row-sharded over 'graph' AND column-sharded over
  'model' — the biggest parameter gets both axes
- W1 [hidden, classes]: row-sharded over 'model' (row parallel) -> partial
  logits psum'd over 'model'
- SpMM: all_gather of the hidden block over 'graph' + local sorted
  segment-sum into the owned dst rows; the 'model' axis never communicates
  inside the graph aggregation.

The reference has no distributed execution at all (SURVEY.md section 2.9);
this is the scale-out design for dims beyond one device's memory.
"""
from __future__ import annotations

from functools import partial
import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .distributed import ShardedGraph


def make_2d_mesh(n_graph: int, n_model: int) -> Mesh:
    devs = jax.devices()
    assert len(devs) >= n_graph * n_model
    return jax.make_mesh((n_graph, n_model), ("graph", "model"),
                         devices=devs[: n_graph * n_model])


def init_2d_teacher(rng, n_node_pad: int, n_feat: int, n_hidden: int,
                    n_class: int):
    k1, k2, k3 = jax.random.split(rng, 3)
    xavier = jax.nn.initializers.xavier_uniform()
    return {
        "w0": xavier(k1, (n_feat, n_hidden)),
        "b0": jnp.zeros((n_hidden,)),
        "se0": jax.random.normal(k3, (n_node_pad, n_hidden)),
        "w1": xavier(k2, (n_hidden, n_class)),
        "b1": jnp.zeros((n_class,)),
    }


def param_shardings_2d(mesh: Mesh, params):
    spec = {
        "w0": P(None, "model"),
        "b0": P("model"),
        "se0": P("graph", "model"),
        "w1": P("model", None),
        "b1": P(),
    }
    return {k: NamedSharding(mesh, spec[k]) for k in params}


def batch_shardings_2d(mesh: Mesh, batch):
    return {
        k: NamedSharding(mesh, P("graph", None) if v.ndim == 2 else P("graph"))
        for k, v in batch.items()
    }


def make_2d_train_step(mesh: Mesh, lr: float = 1e-2, se_reg: float = 1.0):
    """SGD step over the 2-D mesh: step(params, batch, sg)."""

    def body(params, batch, senders, recv_local, ew, rows_per_shard):
        x = batch["x"]  # [rows, feat] local
        y = batch["y"]
        train_mask = batch["train_mask"]
        out_s = (jnp.clip(batch["deg_out"], 1, None) ** -0.5)[:, None]
        in_s = (jnp.clip(batch["deg_in"], 1, None) ** -0.5)[:, None]

        senders, recv_local, ew = senders[0], recv_local[0], ew[0]

        # layer 1: column-parallel W0 + row/col-sharded SE
        h = (x * out_s) @ params["w0"] + params["se0"]  # [rows, hid/M]
        h_all = jax.lax.all_gather(h, "graph", axis=0, tiled=True)
        agg = jax.ops.segment_sum(
            h_all[senders] * ew[:, None], recv_local,
            num_segments=rows_per_shard,
        )
        h = jax.nn.relu(agg * in_s + params["b0"])

        # layer 2: row-parallel W1 -> psum partials over 'model'
        logits = jax.lax.psum(h @ params["w1"], "model") + params["b1"]
        logits_all = jax.lax.all_gather(logits, "graph", axis=0, tiled=True)
        # aggregate layer-2 over the graph too (plain GCN layer without SE)
        agg2 = jax.ops.segment_sum(
            logits_all[senders] * ew[:, None], recv_local,
            num_segments=rows_per_shard,
        )
        logits = agg2 * in_s

        lsm = jax.nn.log_softmax(logits, axis=1)
        picked = jnp.take_along_axis(lsm, y[:, None], axis=1)[:, 0]
        m = train_mask.astype(jnp.float32)
        num = jax.lax.psum(jnp.sum(picked * m), "graph")
        den = jax.lax.psum(jnp.sum(m), "graph")
        loss = -num / jnp.maximum(den, 1.0)
        # SE Frobenius reg across both shardings
        sq = jax.lax.psum(
            jax.lax.psum(jnp.sum(params["se0"] ** 2), "graph"), "model"
        )
        return loss + se_reg * jnp.sqrt(sq)

    def loss_fn(params, batch, sg: ShardedGraph):
        f = shard_map(
            partial(body, rows_per_shard=sg.rows_per_shard),
            mesh=mesh,
            in_specs=(
                {
                    "w0": P(None, "model"),
                    "b0": P("model"),
                    "se0": P("graph", "model"),
                    "w1": P("model", None),
                    "b1": P(),
                },
                {
                    "x": P("graph", None),
                    "y": P("graph"),
                    "train_mask": P("graph"),
                    "deg_in": P("graph"),
                    "deg_out": P("graph"),
                },
                P("graph", None),
                P("graph", None),
                P("graph", None),
            ),
            out_specs=P(),
            check_vma=False,
        )
        return f(params, batch, sg.senders, sg.receivers_local,
                 sg.edge_weight)

    @jax.jit
    def step(params, batch, sg):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch, sg)
        params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return params, loss

    return step
