"""Multi-device graph sharding and the distributed SpMM / train step.

NOTE: the PRODUCT multi-device path is ``parallel/distgraph.py``
(DistGraph) — the full TricksComb teacher on the mesh with a ring
aggregation, reachable via ``data.prepare_sharded`` /
``main.py --n_devices``. This module keeps the
round-1 building blocks (all_gather SpMM, segment-sum ring, bespoke
2-layer train step) as tested primitives and for the dryrun's legacy
sections.

The reference is strictly single-device (SURVEY.md section 2.9: one GPU,
unused DDP import utils.py:22). This module is the scale-out story it
lacks:

- 1-D destination-row partition of the graph over a ``('graph',)`` mesh
  axis: device k owns the contiguous dst-row block [k*R, (k+1)*R) and every
  edge landing in it; node features / labels / SE tables are row-sharded to
  match, dense weights are replicated.
- Aggregation inside ``shard_map``: all_gather the sharded source features
  over the axis (a collective), then a local sorted segment-sum into the
  owned row block. The backward of all_gather is reduce_scatter — XLA
  derives the transposed SpMM automatically, riding the same links.
- The full train step (forward, loss, backward, optimizer update) jits over
  the mesh; W grads are implicitly psum'd by shard_map's replication rule,
  SE-table grads stay sharded.

Tested on a virtual 8-device CPU mesh (tests/), dry-run compiled by the
driver via __graft_entry__.dryrun_multichip.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def make_graph_mesh(n_devices: Optional[int] = None, axis: str = "graph") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return jax.make_mesh((n,), (axis,), devices=devs[:n])


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["senders", "receivers_local", "edge_weight"],
    meta_fields=["n_node", "n_node_pad", "rows_per_shard", "n_shards"],
)
@dataclass(frozen=True)
class ShardedGraph:
    """Edge arrays stacked per shard: shape [n_shards, E_shard]. Shard k's
    receivers are stored relative to its row offset k*rows_per_shard.
    Padding edges point at local row 0 with weight 0."""

    senders: jax.Array  # [S, E_shard] int32, global node ids
    receivers_local: jax.Array  # [S, E_shard] int32, local row ids, sorted
    edge_weight: jax.Array  # [S, E_shard] f32
    n_node: int
    n_node_pad: int
    rows_per_shard: int
    n_shards: int


def shard_graph(
    edge_index: np.ndarray,
    n_node: int,
    n_shards: int,
    edge_weight: Optional[np.ndarray] = None,
    pad_multiple: int = 8,
) -> ShardedGraph:
    """Host-side 1-D dst-row partition with per-shard edge padding."""
    e = np.asarray(edge_index, np.int64)
    w = (
        np.ones(e.shape[1], np.float32)
        if edge_weight is None
        else np.asarray(edge_weight, np.float32)
    )
    n_node_pad = ((n_node + n_shards - 1) // n_shards) * n_shards
    rows = n_node_pad // n_shards

    shard_of = e[1] // rows
    counts = np.bincount(shard_of, minlength=n_shards)
    e_shard = ((int(counts.max()) + pad_multiple - 1) // pad_multiple) * pad_multiple
    e_shard = max(e_shard, pad_multiple)

    senders = np.zeros((n_shards, e_shard), np.int32)
    recv_local = np.zeros((n_shards, e_shard), np.int32)
    ws = np.zeros((n_shards, e_shard), np.float32)
    for k in range(n_shards):
        sel = shard_of == k
        order = np.argsort(e[1, sel], kind="stable")
        s, r, wk = e[0, sel][order], e[1, sel][order], w[sel][order]
        senders[k, : len(s)] = s
        recv_local[k, : len(s)] = r - k * rows
        ws[k, : len(s)] = wk
        # pads: local row 0, weight 0 (sorted order preserved is not needed
        # for correctness of segment_sum without the sorted hint per shard;
        # we keep indices_are_sorted=False on the sharded path)
    return ShardedGraph(
        senders=jnp.asarray(senders),
        receivers_local=jnp.asarray(recv_local),
        edge_weight=jnp.asarray(ws),
        n_node=n_node,
        n_node_pad=n_node_pad,
        rows_per_shard=rows,
        n_shards=n_shards,
    )


def pad_rows(x: np.ndarray, n_node_pad: int) -> np.ndarray:
    pad = n_node_pad - x.shape[0]
    if pad == 0:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)


def dist_spmm(mesh: Mesh, sg: ShardedGraph, x, axis: str = "graph"):
    """y = A @ x with x, y row-sharded over ``axis``. x: [n_node_pad, d]."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis, None)),
        out_specs=P(axis, None),
        check_vma=False,
    )
    def f(x_local, senders, recv_local, w):
        senders, recv_local, w = senders[0], recv_local[0], w[0]
        x_all = jax.lax.all_gather(x_local, axis, axis=0, tiled=True)
        contrib = x_all[senders] * w[:, None].astype(x_local.dtype)
        return jax.ops.segment_sum(
            contrib, recv_local, num_segments=sg.rows_per_shard
        )

    return f(x, sg.senders, sg.receivers_local, sg.edge_weight)


# ---------------------------------------------------------------------------
# Ring-overlapped variant: stream remote feature blocks around the ring
# ---------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["senders_local", "receivers_local", "edge_weight"],
    meta_fields=["n_node", "n_node_pad", "rows_per_shard", "n_shards",
                 "e_bucket"],
)
@dataclass(frozen=True)
class RingShardedGraph:
    """Edges double-bucketed by (dst_shard, src_shard): shape
    [S, S, E_bucket]. senders are LOCAL to their source shard; padding
    edges carry weight 0 and indices 0."""

    senders_local: jax.Array  # [S, S, E_b] int32
    receivers_local: jax.Array  # [S, S, E_b] int32
    edge_weight: jax.Array  # [S, S, E_b] f32
    n_node: int
    n_node_pad: int
    rows_per_shard: int
    n_shards: int
    e_bucket: int


def shard_graph_ring(
    edge_index: np.ndarray,
    n_node: int,
    n_shards: int,
    edge_weight: Optional[np.ndarray] = None,
    pad_multiple: int = 8,
) -> RingShardedGraph:
    e = np.asarray(edge_index, np.int64)
    w = (np.ones(e.shape[1], np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32))
    n_node_pad = ((n_node + n_shards - 1) // n_shards) * n_shards
    rows = n_node_pad // n_shards
    from .. import native as _native

    nat = _native.ring_bucket_arrays(e[0], e[1], w, rows, n_shards,
                                     pad_multiple)
    if nat is not None:
        sl, rl, ws, e_b = nat
    else:
        dst_shard = e[1] // rows
        src_shard = e[0] // rows
        counts = np.zeros((n_shards, n_shards), np.int64)
        np.add.at(counts, (dst_shard, src_shard), 1)
        e_b = ((int(counts.max()) + pad_multiple - 1) // pad_multiple) \
            * pad_multiple
        e_b = max(e_b, pad_multiple)

        sl = np.zeros((n_shards, n_shards, e_b), np.int32)
        rl = np.zeros((n_shards, n_shards, e_b), np.int32)
        ws = np.zeros((n_shards, n_shards, e_b), np.float32)
        fill = np.zeros((n_shards, n_shards), np.int64)
        for i in range(e.shape[1]):
            k, j = dst_shard[i], src_shard[i]
            p = fill[k, j]
            sl[k, j, p] = e[0, i] - j * rows
            rl[k, j, p] = e[1, i] - k * rows
            ws[k, j, p] = w[i]
            fill[k, j] += 1
    return RingShardedGraph(
        senders_local=jnp.asarray(sl),
        receivers_local=jnp.asarray(rl),
        edge_weight=jnp.asarray(ws),
        n_node=n_node,
        n_node_pad=n_node_pad,
        rows_per_shard=rows,
        n_shards=n_shards,
        e_bucket=e_b,
    )


def dist_spmm_ring(mesh: Mesh, rg: RingShardedGraph, x,
                   axis: str = "graph"):
    """Ring-streamed SpMM: instead of all_gathering the whole feature
    matrix, pass blocks around the ring (ppermute) and aggregate
    the matching (dst_shard, src_shard) edge bucket at each step — the
    long-context/ring-attention pattern applied to neighborhood
    aggregation (SURVEY.md section 5). Peak memory: one remote block
    instead of the full [N, d]."""
    s = rg.n_shards

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None, None), P(axis, None, None),
                  P(axis, None, None)),
        out_specs=P(axis, None),
        check_vma=False,
    )
    def f(x_local, senders, recv, w):
        senders, recv, w = senders[0], recv[0], w[0]  # [S, E_b]
        k = jax.lax.axis_index(axis)
        y = jnp.zeros((rg.rows_per_shard, x_local.shape[1]), x_local.dtype)
        blk = x_local
        for t in range(s):
            j = (k + t) % s  # which source shard's block we hold now
            sl = jnp.take(senders, j, axis=0)
            rl = jnp.take(recv, j, axis=0)
            wb = jnp.take(w, j, axis=0)
            contrib = blk[sl] * wb[:, None].astype(blk.dtype)
            y = y + jax.ops.segment_sum(
                contrib, rl, num_segments=rg.rows_per_shard
            )
            if t < s - 1:
                blk = jax.lax.ppermute(
                    blk, axis, [(i, (i - 1) % s) for i in range(s)]
                )
        return y

    return f(x, rg.senders_local, rg.receivers_local, rg.edge_weight)


# ---------------------------------------------------------------------------
# Distributed teacher train step (2-layer GCN + SE) — the dryrun workload
# ---------------------------------------------------------------------------


def init_dist_teacher(
    rng, n_node_pad: int, n_feat: int, n_hidden: int, n_class: int,
    has_se: Tuple[int, int] = (1, 0),
):
    k1, k2, k3 = jax.random.split(rng, 3)
    xavier = jax.nn.initializers.xavier_uniform()
    params = {
        "w0": xavier(k1, (n_feat, n_hidden)),
        "b0": jnp.zeros((n_hidden,)),
        "w1": xavier(k2, (n_hidden, n_class)),
        "b1": jnp.zeros((n_class,)),
    }
    if has_se[0]:
        params["se0"] = jax.random.normal(k3, (n_node_pad, n_hidden))
    if has_se[1]:
        params["se1"] = jax.random.normal(
            jax.random.fold_in(k3, 1), (n_node_pad, n_class)
        )
    return params


def param_shardings(mesh: Mesh, params, axis: str = "graph"):
    """SE tables row-sharded, dense weights replicated."""

    def spec(path, _):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        if name.startswith("se"):
            return NamedSharding(mesh, P(axis, None))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(spec, params)


def dist_teacher_loss(mesh: Mesh, sg: ShardedGraph, params, x, y, train_mask,
                      deg_in, deg_out, se_reg: float = 10.0,
                      axis: str = "graph"):
    """2-layer GCN+SE forward + masked CE over the row-sharded graph.
    deg_* are [n_node_pad] row-sharded; y/train_mask likewise."""
    out_s = (jnp.clip(deg_out, 1, None) ** -0.5)[:, None]
    in_s = (jnp.clip(deg_in, 1, None) ** -0.5)[:, None]

    h = (x * out_s) @ params["w0"]
    if "se0" in params:
        h = h + params["se0"]
    h = dist_spmm(mesh, sg, h, axis) * in_s + params["b0"]
    h = jax.nn.relu(h)

    h = (h * out_s) @ params["w1"]
    if "se1" in params:
        h = h + params["se1"]
    logits = dist_spmm(mesh, sg, h, axis) * in_s + params["b1"]

    lsm = jax.nn.log_softmax(logits, axis=1)
    picked = jnp.take_along_axis(lsm, y[:, None], axis=1)[:, 0]
    m = train_mask.astype(jnp.float32)
    loss = -jnp.sum(picked * m) / jnp.maximum(jnp.sum(m), 1.0)
    if "se0" in params:
        loss = loss + se_reg * jnp.linalg.norm(params["se0"].reshape(-1))
    if "se1" in params:
        loss = loss + se_reg * jnp.linalg.norm(params["se1"].reshape(-1))
    return loss


def make_dist_train_step(mesh: Mesh, lr: float = 1e-2,
                         se_reg: float = 10.0, axis: str = "graph"):
    """jitted SGD train step over the mesh: step(params, batch, sg).

    The ShardedGraph is a step ARGUMENT, not a closure: closed-over device
    arrays get baked into the lowered module as constants, which forces a
    device->host readback at lowering time and bloats the executable."""

    def loss_fn(params, batch, sg):
        return dist_teacher_loss(
            mesh, sg, params, batch["x"], batch["y"], batch["train_mask"],
            batch["deg_in"], batch["deg_out"], se_reg, axis,
        )

    @jax.jit
    def step(params, batch, sg):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch, sg)
        params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return params, loss

    return step
