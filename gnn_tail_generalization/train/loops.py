"""Jitted training loops: TeacherGNN, SEMLP (two-phase), students, pure LP.

Reference parity: ``/root/reference/trainer_node_classification.py``
- trainer.main dispatch (10-30)
- train_teacherGNN (303-372) + run_trainSet/run_testSet (382-495):
  full-graph epochs, NLL + se_reg * sum ||E^l||_F, head/tail/iso eval per
  epoch, best-by-test checkpoint kept when training for SEMLP
- train_seMLP_part1 (66-124): teacher best ckpt -> collect_SE targets ->
  MSE on random 64k-with-replacement train batches
- train_seMLP_part2 (126-207): CE on random batches (+ NContrastive *
  graphMLP_reg for GraphMLP), head/tail/iso eval via forward on idx subsets
- run_pureLP (33-63): DAD, alpha .5, 50 propagations from train labels

Each epoch is ONE jitted step (forward+backward+update+evals
fused); batches are drawn inside jit with jax.random (uniform with
replacement — np.random.choice(idx, B) semantics, main.py:93).
PRNG-key discipline replaces the reference's global set_seed (main.py:40-52).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp
import optax

from ..config import Config
from ..data.datasets import PreparedData
from ..models.semlp import (
    GraphMLP,
    SEMLPPart1,
    SEMLPPart2,
    neighbor_contrastive_loss,
)
from ..models.teacher import TeacherGNN
from ..propagation import correlation as corr
from .evalutil import headtail_accuracies, masked_accuracy
from .optim import make_optimizer


@dataclass
class TrainResult:
    columns: List[str]
    records: np.ndarray  # [epochs, len(columns)]
    variables: Any
    best_variables: Any = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def last(self, col: str) -> float:
        return float(self.records[-1, self.columns.index(col)])

    def best(self, col: str) -> float:
        return float(self.records[:, self.columns.index(col)].max())


def _split_masks(data: PreparedData):
    train_mask = jnp.asarray(data.train_mask)
    s = data.splits
    large = jnp.asarray(s.large_deg_mask) if s else None
    small = jnp.asarray(s.small_deg_mask) if s else None
    zero = (
        jnp.asarray(s.zero_deg_mask)
        if (s and s.zero_deg_mask is not None)
        else None
    )
    return train_mask, large, small, zero


def _nll_masked(logits, y, mask):
    lsm = jax.nn.log_softmax(logits, axis=1)
    picked = jnp.take_along_axis(lsm, y[:, None], axis=1)[:, 0]
    m = mask.astype(jnp.float32)
    # where (not *0) so masked-out rows can hold non-finite garbage — e.g.
    # the zero rows of a loss_masked_view produce -inf log-softmax entries
    picked = jnp.where(mask, picked, 0.0)
    return -jnp.sum(picked) / jnp.maximum(jnp.sum(m), 1.0)


# ---------------------------------------------------------------------------
# TeacherGNN
# ---------------------------------------------------------------------------


def final_agg_view(cfg: Config, data: PreparedData, *, is_dist: bool):
    """The loss-masked final-layer graph (Config.optimize_final_layer_agg)
    or None. THE single gate for the optimization — valid only when the
    train-mode last-conv output reaches the loss exclusively through the
    row-masked NLL: no edgewise loss, no cross-row norm trick, no graph
    dropout (which rewires per-layer graphs itself), and a real nodewise
    loss. bench.py uses this same helper. On a DistGraph the view is a
    second (smaller) DistGraph over the train-dst edge subset with the
    FULL graph's degree vectors."""
    if not (cfg.optimize_final_layer_agg
            and cfg.has_loss_component_nodewise
            and not cfg.has_loss_component_edgewise
            and not cfg.apply_graph_dropout):
        return None
    from ..nn.norms import norm_applies

    if norm_applies(cfg.type_trick):
        return None
    # host mask from train_idx (always host) — data.train_mask may be a
    # multi-process sharded device array that no process can fetch whole
    n_node = getattr(data.graph, "n_node", None) or data.n_node
    m = np.zeros(n_node, bool)
    m[np.asarray(data.train_idx)] = True
    if is_dist:
        from ..parallel.distgraph import build_dist_graph

        g = data.graph
        e = data.edge_index
        sub = build_dist_graph(
            e[:, m[e[1]]], g.n_node, g.mesh, axis=g.axis,
            model_axis=g.model_axis, rb=g.rb,
        )
        assert sub.n_node_pad == g.n_node_pad
        return dataclasses.replace(sub, deg_in=g.deg_in,
                                   deg_out=g.deg_out)
    from ..graph.core import loss_masked_view

    return loss_masked_view(data.graph, data.edge_index, m)


def train_teacher(
    cfg: Config,
    data: PreparedData,
    seed: int = 0,
    epochs: Optional[int] = None,
    log_every: int = 0,
    save_dir: Optional[str] = None,
    epoch_block: int = 1,
) -> TrainResult:
    epochs = epochs if epochs is not None else cfg.epochs
    # Multi-chip: a DistGraph in PreparedData (data.prepare_sharded) routes
    # aggregation through the ring shard_map SpMM; everything else below is
    # partitioned by GSPMD from the input shardings. SE tables must span
    # the padded row count.
    from ..parallel.distgraph import DistGraph

    dist_mesh = None
    if isinstance(data.graph, DistGraph):
        dist_mesh = data.graph.mesh
        if cfg.N_nodes != data.graph.n_node_pad:
            cfg = dataclasses.replace(cfg, N_nodes=data.graph.n_node_pad)
    # Device data is passed to the jitted step as ARGUMENTS, never closed
    # over: closure device arrays get baked into the lowered module as
    # constants (host readback at lowering time + executable bloat).
    const = {
        "g": data.graph,
        "x": jnp.asarray(data.x),
        "y": jnp.asarray(data.y),
        "test_mask": jnp.asarray(data.test_mask),
    }
    train_mask, large, small, zero = _split_masks(data)
    const["train_mask"] = train_mask
    want_ht = cfg.want_headtail and data.splits is not None
    if want_ht:
        const["large"] = large
        const["small"] = small
        if zero is not None:
            const["zero"] = zero

    model = TeacherGNN(cfg)
    g_last = final_agg_view(cfg, data, is_dist=dist_mesh is not None)
    if g_last is not None:
        const["g_last"] = g_last
    ew_fn = None
    if cfg.has_loss_component_edgewise:
        from .edgewise import (
            build_edgewise_plan, edgewise_consts, make_edgewise_loss_fn,
        )

        # sharded: the DistMult pair rows are assembled via ONE [4K, d]
        # psum (parallel/distgraph.dist_take_rows) — the plan itself is
        # host data either way
        _ew_plan = build_edgewise_plan(cfg, data)
        ew_fn = make_edgewise_loss_fn(
            _ew_plan, dist_graph=data.graph if dist_mesh is not None else None)
        const["ew"] = edgewise_consts(_ew_plan)
    root = jax.random.PRNGKey(seed)
    k_init, k_run = jax.random.split(root)
    variables = jax.jit(
        lambda g, x: model.init(
            {"params": k_init, "dropout": k_init, "graph_dropout": k_init},
            g, x, train=True,
        )
    )(const["g"], const["x"])
    params = variables["params"]
    batch_stats = variables.get("batch_stats")
    if dist_mesh is not None:
        from ..parallel.distgraph import shard_params

        params = shard_params(dist_mesh, params, data.graph.axis,
                              data.graph.model_axis)
        npad, nreal = data.graph.n_node_pad, data.graph.n_node
        if npad > nreal:
            # zero the SE padding rows: ||E||_F and its gradients then match
            # an unpadded single-device run, and Adam keeps them at zero
            rowmask = (jnp.arange(npad) < nreal).astype(jnp.float32)[:, None]

            def _zero_pad(path, leaf):
                names = [p.key if hasattr(p, "key") else str(p)
                         for p in path]
                if any(n == "se" for n in names):
                    return leaf * rowmask
                return leaf

            params = jax.tree_util.tree_map_with_path(_zero_pad, params)
    tx = make_optimizer(cfg)
    opt_state = tx.init(params)

    cols = ["loss_train", "acc_train", "acc_test"] + (
        ["head", "tail"] + (["iso"] if zero is not None else [])
        if want_ht
        else []
    ) + (["linkp_train", "linkp_test"] if ew_fn is not None else [])

    def loss_fn(params, batch_stats, rng, c):
        vs = {"params": params}
        if batch_stats is not None:
            vs["batch_stats"] = batch_stats
        rngs = {"dropout": rng, "graph_dropout": jax.random.fold_in(rng, 1)}
        mutable = ["batch_stats"] if batch_stats is not None else []
        out, new_vars = model.apply(
            vs, c["g"], c["x"], train=True, rngs=rngs, mutable=mutable,
            g_last=c.get("g_last"),
        )
        common, classi, se_reg_all, _ = out
        loss = 0.0
        linkp_train = 0.0
        if cfg.has_loss_component_nodewise:
            loss = _nll_masked(classi, c["y"], c["train_mask"]) \
                * cfg.TeacherGNN.lossa_semantic
        if se_reg_all is not None:
            loss = loss + cfg.se_reg * se_reg_all
        if ew_fn is not None:
            # linkp uses the full (unmasked) embedding (trainer:418)
            l_struct, linkp_train = ew_fn(
                common, jax.random.fold_in(rng, 2), "train", c["ew"]
            )
            loss = loss + l_struct * cfg.TeacherGNN.lossa_structure
        new_bs = new_vars.get("batch_stats") if mutable else batch_stats
        return loss, (new_bs, linkp_train)

    def step_impl(params, batch_stats, opt_state, rng, c):
        (loss, (new_bs, linkp_train)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params, batch_stats, rng, c)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        # eval-mode full forward (run_testSet, trainer:453-495)
        vs = {"params": params}
        if new_bs is not None:
            vs["batch_stats"] = new_bs
        common_eval, classi, _, _ = model.apply(vs, c["g"], c["x"],
                                                train=False)
        y, train_mask = c["y"], c["train_mask"]
        metrics = {
            "loss_train": loss,
            "acc_train": masked_accuracy(classi, y, train_mask) * 100.0,
            "acc_test": masked_accuracy(classi, y, c["test_mask"]) * 100.0,
        }
        if want_ht:
            metrics.update(
                headtail_accuracies(classi, y, train_mask, c["large"],
                                    c["small"], c.get("zero"))
            )
        if ew_fn is not None:
            _, linkp_test = ew_fn(
                common_eval, jax.random.fold_in(rng, 5), "test", c["ew"]
            )
            metrics["linkp_train"] = linkp_train
            metrics["linkp_test"] = linkp_test
        # single stacked vector -> ONE device->host pull per epoch
        mvec = jnp.stack([jnp.asarray(metrics[c2], jnp.float32)
                          for c2 in cols])
        return params, new_bs, opt_state, mvec

    step = jax.jit(step_impl)

    records = np.zeros((epochs, len(cols)), np.float64)
    keep_best = "SEMLP" in cfg.train_which
    best_acc, best_params, best_bs = -1.0, None, None

    # epoch_block > 1: scan blocks of epochs inside one jit, one host pull
    # per block (amortizes dispatch and sync latency). Best-ckpt capture happens
    # INSIDE the scan: the carry holds (best_acc, best_params, best_bs) and
    # snapshots via jnp.where per epoch, so SEMLP teacher runs (keep_best)
    # get the same ~block-x host-sync reduction as plain teacher runs.
    # NOTE _run_epoch_loop is the shared (no-extra-carry) version of this
    # machinery — keep fixes in sync between the two.
    block = max(1, epoch_block)
    acc_i = cols.index("acc_test")

    if block > 1:
        @jax.jit
        def multi_step(params, batch_stats, opt_state, k_run, best, c):
            # consumes the SAME k_run split chain as the per-epoch loop, so
            # results are bitwise-identical across block sizes
            def body(carry, _):
                p, bs, o, kr, best = carry
                kr, k = jax.random.split(kr)
                p, bs, o, mvec = step_impl(p, bs, o, k, c)
                if keep_best:  # python-static: structure fixed per trace
                    b_acc, b_p, b_bs = best
                    better = mvec[acc_i] > b_acc
                    b_p = jax.tree.map(
                        lambda b, n: jnp.where(better, n, b), b_p, p)
                    b_bs = jax.tree.map(
                        lambda b, n: jnp.where(better, n, b), b_bs, bs)
                    best = (jnp.where(better, mvec[acc_i], b_acc), b_p, b_bs)
                return (p, bs, o, kr, best), mvec

            (params, batch_stats, opt_state, k_run, best), ms = jax.lax.scan(
                body, (params, batch_stats, opt_state, k_run, best), None,
                length=block,
            )
            return params, batch_stats, opt_state, k_run, best, ms

    best_dev = (jnp.float32(-1.0), params, batch_stats)
    epoch = 0
    while epoch < epochs:
        if block > 1 and epochs - epoch >= block:
            params, batch_stats, opt_state, k_run, best_dev, ms = multi_step(
                params, batch_stats, opt_state, k_run, best_dev, const
            )
            records[epoch:epoch + block] = np.asarray(ms)
            if keep_best:
                best_params, best_bs = best_dev[1], best_dev[2]
            n_done = block
        else:
            k_run, k = jax.random.split(k_run)
            params, batch_stats, opt_state, mvec = step(
                params, batch_stats, opt_state, k, const
            )
            records[epoch] = np.asarray(mvec)
            n_done = 1
        for e in range(epoch, epoch + n_done):
            acc_test = float(records[e, acc_i])
            if acc_test > best_acc:
                best_acc = acc_test
                # device-side capture already handled blocked epochs; only
                # per-epoch (tail) steps snapshot host-side
                if keep_best and n_done == 1:
                    best_params = jax.tree.map(lambda a: a, params)
                    best_bs = batch_stats
            if log_every and e % log_every == 0:
                print(f"Ep{e:03d} " + " ".join(
                    f"{c}={records[e, i]:.2f}" for i, c in enumerate(cols)
                ))
        epoch += n_done

    final_vars = {"params": params}
    if batch_stats is not None:
        final_vars["batch_stats"] = batch_stats
    best_vars = None
    if keep_best and best_params is not None:
        best_vars = {"params": best_params}
        if best_bs is not None:
            best_vars["batch_stats"] = best_bs
    if save_dir:
        # save_model semantics (utils.py:958-960, trainer:334,351):
        # last checkpoint always; best-by-test kept when training for SEMLP
        from .checkpoint import save_train_state

        save_train_state(f"{save_dir}/teacherGNN.npz",
                         params=final_vars["params"],
                         batch_stats=final_vars.get("batch_stats"),
                         epoch=epochs)
        if keep_best and best_vars is not None:
            save_train_state(f"{save_dir}/best-teacherGNN.npz",
                             params=best_vars["params"],
                             batch_stats=best_vars.get("batch_stats"),
                             epoch=epochs)
    return TrainResult(
        columns=cols,
        records=records,
        variables=final_vars,
        best_variables=best_vars or final_vars,
        extra={"model": model, "best_acc_test": best_acc},
    )


def _dist_graph_of(data: PreparedData):
    """The DistGraph when ``data`` came from prepare_sharded, else None."""
    from ..parallel.distgraph import DistGraph

    g = data.graph
    return g if isinstance(g, DistGraph) else None


def _make_take_rows(data: PreparedData):
    """Batch row-gather for the student loops: plain ``arr[idx]`` single-
    device; ONE [B, d] psum per gather on a DistGraph (dist_take_rows) so
    the sharded feature/SE tables are never replicated. 1-D arrays
    (labels, masks) ride the same psum lifted to [N, 1] — GSPMD refuses
    to pick an out-sharding for a replicated-index gather from a sharded
    operand on its own."""
    dg = _dist_graph_of(data)
    if dg is None:
        return lambda arr, idx: arr[idx]
    from ..parallel.distgraph import dist_take_rows

    def take(arr, idx):
        if arr.ndim == 1:
            out = dist_take_rows(dg, arr.astype(jnp.float32)[:, None],
                                 idx)[:, 0]
            if arr.dtype == jnp.bool_:
                return out > 0.5
            return out.astype(arr.dtype)
        return dist_take_rows(dg, arr, idx)

    return take


def collect_teacher_se(cfg: Config, data: PreparedData, teacher_vars,
                       rng=None) -> jax.Array:
    """Teacher SE table = concat of per-layer embeddings on the full graph
    (trainer:87, GCN.py:148-150). Deterministic by default; pass an rng with
    cfg.bug_compat_part1_target_dropout for the reference's train-mode
    sample. On a DistGraph the result is row-sharded [n_node_pad, se_dim]
    (padding rows are masked out downstream by the dist replace op)."""
    model = TeacherGNN(cfg)
    x = jnp.asarray(data.x)
    train = bool(cfg.bug_compat_part1_target_dropout)
    rngs = {"dropout": rng} if (train and rng is not None) else None

    @partial(jax.jit, static_argnames=("train_",))
    def run(v, g, x, train_):
        _, _, _, les = model.apply(v, g, x, train=train_, want_les=True,
                                   rngs=rngs)
        return jax.lax.stop_gradient(les)

    return run(teacher_vars, data.graph, x, train)


# ---------------------------------------------------------------------------
# SEMLP part 1: feature -> teacher SE regression
# ---------------------------------------------------------------------------


def _run_epoch_loop(step_fn, params, opt_state, k_run, const, epochs,
                    epoch_block, n_cols, log_fn=None):
    """Drive ``epochs`` of ``step_fn(params, opt_state, rng, c) ->
    (params, opt_state, mvec)``, scanning ``epoch_block`` epochs per
    jitted call — ONE host pull per block instead of per epoch. The RNG
    chain (split k_run per epoch) is identical across block sizes, so
    records are bitwise-equal to per-epoch stepping.

    NOTE train_teacher keeps its own inline copy of this block/tail loop
    because its carry additionally holds batch_stats and the in-scan
    best-checkpoint tuple — if you fix RNG handoff / records slicing /
    host-pull behavior here, mirror it there (and vice versa)."""
    records = np.zeros((epochs, n_cols), np.float64)
    step_jit = jax.jit(step_fn)
    block = max(1, epoch_block)
    if block > 1:
        @jax.jit
        def multi(params, opt_state, k_run, c):
            def body(carry, _):
                p, o, kr = carry
                kr, k = jax.random.split(kr)
                p, o, m = step_fn(p, o, k, c)
                return (p, o, kr), m

            (p, o, kr), ms = jax.lax.scan(
                body, (params, opt_state, k_run), None, length=block)
            return p, o, kr, ms

    epoch = 0
    while epoch < epochs:
        if block > 1 and epochs - epoch >= block:
            params, opt_state, k_run, ms = multi(params, opt_state, k_run,
                                                 const)
            records[epoch: epoch + block] = np.asarray(ms)
            n_done = block
        else:
            k_run, k = jax.random.split(k_run)
            params, opt_state, m = step_jit(params, opt_state, k, const)
            records[epoch] = np.asarray(m)
            n_done = 1
        if log_fn:
            for e2 in range(epoch, epoch + n_done):
                log_fn(e2, records[e2])
        epoch += n_done
    return params, opt_state, records


def train_semlp_part1(
    cfg: Config,
    data: PreparedData,
    teacher_se: jax.Array,
    seed: int = 0,
    epochs: Optional[int] = None,
    log_every: int = 0,
    epoch_block: int = 1,
) -> TrainResult:
    epochs = epochs if epochs is not None else cfg.epochs
    const = {
        "x": jnp.asarray(data.x),
        "se": teacher_se,
        "train_idx": jnp.asarray(data.train_idx),
        "test_idx": jnp.asarray(data.test_idx),
    }
    bsz = min(cfg.batch_size, len(data.train_idx))  # clamp (MLP_model:61-63)
    take = _make_take_rows(data)

    part1 = SEMLPPart1(cfg, se_dim=int(teacher_se.shape[-1]))
    root = jax.random.PRNGKey(seed + 1)
    k_init, k_run = jax.random.split(root)
    # init from a zeros probe (init reads shapes only): slicing the
    # row-sharded x ([:2] of a 4-way shard) is not GSPMD-partitionable
    params = jax.jit(
        lambda x: part1.init(
            {"params": k_init, "dropout": k_init}, x, train=True
        )
    )(jnp.zeros((2, const["x"].shape[1]), jnp.float32))["params"]
    tx = make_optimizer(cfg)
    opt_state = tx.init(params)

    def sample(rng, idx):
        return idx[jax.random.randint(rng, (bsz,), 0, idx.shape[0])]

    def step(params, opt_state, rng, c):
        kb, kd, ke = jax.random.split(rng, 3)
        bidx = sample(kb, c["train_idx"])

        def loss_fn(p):
            out = part1.apply(
                {"params": p}, take(c["x"], bidx), train=True,
                rngs={"dropout": kd}
            )
            return jnp.mean((out - take(c["se"], bidx)) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        tidx = sample(ke, c["test_idx"])
        out_t = part1.apply({"params": params}, take(c["x"], tidx),
                            train=False)
        loss_test = jnp.mean((out_t - take(c["se"], tidx)) ** 2)
        return params, opt_state, jnp.stack([loss, loss_test])

    cols = ["loss_train", "loss_test"]

    def log_fn(e, rec):
        if log_every and e % log_every == 0:
            print(f"p1 Ep{e:03d} train/test mse "
                  f"{rec[0]:.4f}/{rec[1]:.4f}")

    params, opt_state, records = _run_epoch_loop(
        step, params, opt_state, k_run, const, epochs, epoch_block,
        len(cols), log_fn)
    return TrainResult(cols, records, {"params": params},
                       extra={"model": part1})


# ---------------------------------------------------------------------------
# SEMLP part 2 / StudentBaseMLP / GraphMLP
# ---------------------------------------------------------------------------


def _sparse_adj_pow(data: PreparedData, r: int):
    """GraphMLP's A_tilde^r as a scipy CSR (graphUtils.normalize_adj +
    sparse_power, utils.py:1225-1248). The reference stays sparse at scale
    (utils.py:1242-1248) — so do we; the train loop crops [B, B] blocks
    per batch host-side and ships only those to the device."""
    import scipy.sparse as sp

    from ..graph.core import add_self_loops, remove_self_loops

    e = remove_self_loops(data.edge_index)
    e = add_self_loops(e, data.n_node)
    n = data.n_node
    a = sp.csr_matrix(
        (np.ones(e.shape[1]), (e[0], e[1])), shape=(n, n)
    )
    d = np.asarray(a.sum(axis=1)).reshape(-1)
    dinv = sp.diags(d**-0.5)
    at = (dinv @ a @ dinv).tocsr()
    out = at
    for _ in range(r - 1):
        out = out @ at
    return out.tocsr().astype(np.float32)


def _dense_adj_pow(data: PreparedData, r: int) -> np.ndarray:
    """Dense [N, N] materialization of _sparse_adj_pow for small graphs
    (one [B, B] gather inside jit beats per-step host crops there)."""
    return np.asarray(_sparse_adj_pow(data, r).todense(), np.float32)


def adj_pow_crop(adj_csr, bidx: np.ndarray) -> np.ndarray:
    """Dense [B, B] block A^r[bidx][:, bidx] from the sparse power."""
    return np.asarray(adj_csr[bidx][:, bidx].todense(), np.float32)


def train_semlp_part2(
    cfg: Config,
    data: PreparedData,
    teacher_se: Optional[jax.Array] = None,
    part1_result: Optional[TrainResult] = None,
    seed: int = 0,
    epochs: Optional[int] = None,
    log_every: int = 0,
    epoch_block: int = 1,
) -> TrainResult:
    epochs = epochs if epochs is not None else cfg.epochs
    const = {
        "x": jnp.asarray(data.x),
        "y": jnp.asarray(data.y),
        "train_idx": jnp.asarray(data.train_idx),
        "test_idx": jnp.asarray(data.test_idx),
        "train_mask": jnp.asarray(data.train_mask),
    }
    bsz = min(cfg.batch_size, len(data.train_idx))

    is_graphmlp = cfg.train_which == "GraphMLP"
    downgraded = cfg.SEMLP__downgrade_to_MLP or cfg.train_which in (
        "StudentBaseMLP",
        "GraphMLP",
    )
    if not downgraded:
        assert teacher_se is not None and part1_result is not None
        part1 = part1_result.extra["model"]
        const["params1"] = part1_result.variables["params"]
        const["se"] = teacher_se
    else:
        part1 = None
        const["se"] = jnp.zeros((1, 1))

    sparse_adj = None
    if is_graphmlp:
        if data.n_node <= 8192:  # the [N, N] power fits on the device
            const["adj_pow"] = jnp.asarray(
                _dense_adj_pow(data, cfg.graphMLP_r))
        else:
            # at scale the [N, N] power is infeasible dense (114 GB at
            # arxiv N) — keep it sparse host-side and ship per-batch
            # [B, B] crops (reference stays sparse too, utils.py:1242-1248)
            sparse_adj = _sparse_adj_pow(data, cfg.graphMLP_r)

    take = _make_take_rows(data)
    dg = _dist_graph_of(data)
    replace_fn = None
    if dg is not None and not downgraded:
        # sharded latent-neighbor discovery over the row-sharded SE table
        # (psum-merged per-shard top-k); padding rows masked via n_valid
        from ..ops.topk_attention import make_dist_latent_replace

        assert dg.model_axis is None, (
            "sharded SEMLP currently runs on 1-D ('graph',) meshes — the "
            "SE table must be replicated over any model axis")
        replace_fn = make_dist_latent_replace(
            dg.mesh, dg.axis, dg.rows_per_shard, dg.n_node)

    model = (GraphMLP(cfg) if is_graphmlp
             else SEMLPPart2(cfg, replace_fn=replace_fn))
    root = jax.random.PRNGKey(seed + 2)
    k_init, k_run = jax.random.split(root)

    def fwd(params2, c, bidx, rng, train, crop=None):
        """Returns (logits, aux_loss). ``crop``: precomputed [B, B]
        adjacency-power block (sparse at-scale path); defaults to the
        in-jit gather from the dense const."""
        xb = take(c["x"], bidx)
        rngs = {"dropout": rng} if train else None
        if is_graphmlp:
            logits, z = model.apply(
                {"params": params2}, xb, train=train, rngs=rngs
            )
            if not train:
                # NContrast only enters the train loss (trainer:156-158)
                return logits, 0.0
            if crop is None:
                crop = c["adj_pow"][bidx][:, bidx]
            nc = neighbor_contrastive_loss(z, crop, cfg.graphMLP_tau)
            return logits, nc * cfg.graphMLP_reg
        if part1 is not None:
            # part 1 runs in train mode during part-2 training
            # (module-level .train(), trainer:148-152); grads are stopped
            # inside SEMLPPart2.
            p1rng = {"dropout": jax.random.fold_in(rng, 7)} if train else None
            p1 = part1.apply(
                {"params": c["params1"]}, xb, train=train, rngs=p1rng
            )
        else:
            p1 = jnp.zeros((xb.shape[0], 1))
        logits = model.apply(
            {"params": params2}, xb, p1, c["se"], train=train, rngs=rngs
        )
        return logits, 0.0

    dummy_rng = jax.random.PRNGKey(0)
    params2 = None

    @jax.jit
    def init_params(k, c):
        # zeros probe, not c["x"][:2]: init reads shapes only and a
        # [:2] slice of a row-sharded table is not GSPMD-partitionable
        xb = jnp.zeros((2, c["x"].shape[1]), jnp.float32)
        if is_graphmlp:
            return model.init({"params": k, "dropout": k}, xb, train=True)[
                "params"
            ]
        if part1 is not None:
            p1 = part1.apply({"params": c["params1"]}, xb, train=False)
        else:
            p1 = jnp.zeros((2, 1))
        return model.init(
            {"params": k, "dropout": k}, xb, p1, c["se"], train=True
        )["params"]

    params2 = init_params(k_init, const)
    tx = make_optimizer(cfg)
    opt_state = tx.init(params2)

    def sample(rng, idx):
        return idx[jax.random.randint(rng, (bsz,), 0, idx.shape[0])]

    want_ht = cfg.want_headtail and data.splits is not None
    sp = data.splits
    if want_ht:
        const["large_idx"] = jnp.asarray(sp.large_deg_idx)
        const["small_idx"] = jnp.asarray(sp.small_deg_idx)
        if sp.zero_deg_idx is not None:
            const["zero_idx"] = jnp.asarray(sp.zero_deg_idx)
    has_zero = want_ht and sp is not None and sp.zero_deg_idx is not None

    def subset_test_acc(params2, c, idx):
        """forward on the subset, acc over its non-train part
        (trainer:173-187, eval_headtail__traintest_v2)."""
        logits, _ = fwd(params2, c, idx, dummy_rng, train=False)
        m = ~take(c["train_mask"], idx)
        pred = jnp.argmax(logits, axis=1)
        corr_ = ((pred == take(c["y"], idx)) & m).sum()
        return corr_ / jnp.maximum(m.sum(), 1) * 100.0

    cols = ["loss_train", "acc_test"] + (
        ["head", "tail"] + (["iso"] if has_zero else [])
        if want_ht
        else []
    )

    def step_body(params2, opt_state, rng, c, bidx=None, crop=None):
        kb, kd, ke = jax.random.split(rng, 3)
        if bidx is None:
            bidx = sample(kb, c["train_idx"])

        def loss_fn(p2):
            logits, aux = fwd(p2, c, bidx, kd, train=True, crop=crop)
            lsm = jax.nn.log_softmax(logits, axis=1)
            ce = -jnp.mean(
                jnp.take_along_axis(lsm, take(c["y"], bidx)[:, None],
                                    axis=1)
            )
            return ce + aux

        loss, grads = jax.value_and_grad(loss_fn)(params2)
        updates, opt_state = tx.update(grads, opt_state, params2)
        params2 = jax.tree.map(lambda p, u: p + u, params2, updates)

        tidx = sample(ke, c["test_idx"])
        logits_t, _ = fwd(params2, c, tidx, dummy_rng, train=False)
        metrics = {
            "loss_train": loss,
            "acc_test": masked_accuracy(logits_t, take(c["y"], tidx))
            * 100.0,
        }
        if want_ht:
            metrics["head"] = subset_test_acc(params2, c, c["large_idx"])
            metrics["tail"] = subset_test_acc(params2, c, c["small_idx"])
            if "zero_idx" in c:
                metrics["iso"] = subset_test_acc(params2, c, c["zero_idx"])
        mvec = jnp.stack([jnp.asarray(metrics[c2], jnp.float32)
                          for c2 in cols])
        return params2, opt_state, mvec

    def log_fn(e, rec):
        if log_every and e % log_every == 0:
            print(f"p2 Ep{e:03d} " + " ".join(
                f"{c}={rec[i]:.2f}" for i, c in enumerate(cols)
            ))

    if sparse_adj is None:
        params2, opt_state, records = _run_epoch_loop(
            lambda p, o, r, c: step_body(p, o, r, c), params2, opt_state,
            k_run, const, epochs, epoch_block, len(cols), log_fn)
        return TrainResult(cols, records, {"params": params2},
                           extra={"model": model})

    # sparse-adjacency path: batches drawn host-side so the [B, B]
    # adjacency-power block can be cropped from the scipy CSR per step
    # (epoch blocks don't apply — each step needs a fresh host crop)
    step_crop = jax.jit(
        lambda p, o, r, c, bidx, crop: step_body(p, o, r, c, bidx, crop))
    host_rng = np.random.default_rng(seed * 7919 + 17)
    train_idx_h = np.asarray(data.train_idx)

    records = np.zeros((epochs, len(cols)), np.float64)
    for epoch in range(epochs):
        k_run, k = jax.random.split(k_run)
        bidx_np = train_idx_h[
            host_rng.integers(0, len(train_idx_h), bsz)]
        crop = adj_pow_crop(sparse_adj, bidx_np)
        params2, opt_state, m = step_crop(
            params2, opt_state, k, const,
            jnp.asarray(bidx_np), jnp.asarray(crop))
        records[epoch] = np.asarray(m)
        log_fn(epoch, records[epoch])
    return TrainResult(cols, records, {"params": params2},
                       extra={"model": model})


# ---------------------------------------------------------------------------
# Orchestration (trainer.main dispatch, trainer:10-30) and pure LP
# ---------------------------------------------------------------------------


def run_pure_lp(cfg: Config, data: PreparedData,
                alpha: float = 0.5, num_propagations: int = 50):
    """trainer:33-63: DAD label propagation from train labels. On
    prepare_sharded data the DAD adjacency becomes a DistGraph and the
    50-step propagation runs the ring SpMM (the reference offloads LP to
    CPU, LP_Adj.py:149-152 — a mesh has no such constraint)."""
    dg = _dist_graph_of(data)
    if dg is not None:
        dad = corr.gen_normalized_dist_adj(
            data.edge_index, dg.n_node, dg.mesh, "DAD", axis=dg.axis,
            model_axis=dg.model_axis, rb=dg.rb)
    else:
        dad, _, _ = corr.gen_normalized_adjs(data.edge_index, data.n_node)
    y = jnp.asarray(data.y)
    nc = cfg.num_classes or int(jnp.max(y)) + 1
    out = jax.jit(
        lambda y, idx, g: corr.label_propagation(
            y, idx, g, alpha, num_propagations, nc,
            spmm_method=cfg.spmm_method,
        )
    )(y, jnp.asarray(data.train_idx), dad)
    train_mask = jnp.asarray(data.train_mask)
    # padding rows (dist): False in BOTH masks -> excluded either way
    test_mask = (jnp.asarray(data.test_mask) if dg is not None
                 else ~train_mask)
    acc_train = float(masked_accuracy(out, y, train_mask)) * 100
    acc_test = float(masked_accuracy(out, y, test_mask)) * 100
    return {"acc_train": round(acc_train, 2), "acc_test": round(acc_test, 2)}


def run_experiment(cfg: Config, data: PreparedData, seed: int = 0,
                   epochs: Optional[int] = None, log_every: int = 0,
                   epoch_block: int = 1):
    """trainer.main dispatch (trainer_node_classification.py:10-30).
    ``epoch_block``: scan K epochs per jitted call in every phase (one
    host pull per block; bitwise-identical records)."""
    tw = cfg.train_which
    if tw == "TeacherGNN":
        return train_teacher(cfg, data, seed, epochs, log_every,
                             epoch_block=epoch_block)
    if tw == "LP":
        return run_pure_lp(cfg, data)
    if tw in ("StudentBaseMLP", "GraphMLP"):
        cfg = dataclasses.replace(cfg, SEMLP__downgrade_to_MLP=True)
        return train_semlp_part2(cfg, data, seed=seed, epochs=epochs,
                                 log_every=log_every,
                                 epoch_block=epoch_block)
    if tw == "SEMLP":
        if cfg.SEMLP__downgrade_to_MLP:
            return train_semlp_part2(cfg, data, seed=seed, epochs=epochs,
                                     log_every=log_every,
                                     epoch_block=epoch_block)
        teacher = train_teacher(cfg, data, seed, epochs, log_every,
                                epoch_block=epoch_block)
        se = collect_teacher_se(cfg, data, teacher.best_variables)
        p1 = train_semlp_part1(cfg, data, se, seed, epochs, log_every,
                               epoch_block=epoch_block)
        p2 = train_semlp_part2(cfg, data, se, p1, seed, epochs, log_every,
                               epoch_block=epoch_block)
        p2.extra["teacher"] = teacher
        p2.extra["part1"] = p1
        return p2
    raise ValueError(tw)
