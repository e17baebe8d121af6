"""Smoke run of the main path on an NVIDIA GPU, as one process.

Phases, at the ogbn-arxiv shape (169,343 nodes, 1,166,243 edges before
symmetrizing and self loops, 128 features, hidden 256, 40 classes) unless
stated otherwise:

  spmm          SpMM forward and transposed (its VJP) against scipy CSR in
                float64, d=256 and d=40: f32 to 1e-5 and bf16 operands to
                1e-2 relative Frobenius error
  teacher       ``main.main`` TeacherGNN, 5 epochs on the synthetic
                stand-in: finite records, falling loss
  gpu_vs_cpu    3 teacher train steps on the GPU and on the CPU, dropout
                off, f32 "highest": the losses agree to 1e-4, and so do
                the gradients at the CPU run's parameters of each step
                (relative Frobenius gap over every parameter)
  semlp         ``main.main`` SEMLP (teacher, SE distillation, top-K latent
                neighbours over the 169k-row table), 3 epochs per part
  linkpred      ``train_linkpred`` SAGE+DOT at the ogbl-citation2 shape
                (2,927,963 nodes, 30.4M message edges, 64Ki-edge batches)

``--devices 4`` runs only the multi-device path: ``main.main
--n_devices=4`` TeacherGNN at the arxiv shape, and the sharded losses and
gradients against the single-device ones over 3 steps, dropout off, to
5e-3.

Each phase prints one line with its time and the card's name and power
limit. The last line is ``{"ok": true, "device": {...}}``. A failing phase
raises, so the script exits non-zero and prints no verdict; so it does
without a GPU.

Usage:  python chip_smoke.py [--devices 4]
"""
import argparse
import dataclasses
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

import main as cli
from gnn_tail_generalization.utils.device import (
    device_fields, gpu_name_and_power_limit,
)

ARXIV = dict(n_node=169_343, n_edge=1_166_243, n_feat=128, n_hidden=256,
             n_class=40)
CITATION2 = dict(n_node=2_927_963, n_edge=30_387_995 // 2, n_feat=128)
ARXIV_ARGS = ("--dataset=ogbn-arxiv", "--whetherHasSE=100")


def _rel_fro(y, ref) -> float:
    return float(np.linalg.norm(y - ref) / np.linalg.norm(ref))


def _rel_fro_tree(a, b) -> float:
    """Relative Frobenius gap of pytree ``a`` from ``b``, over all leaves."""
    num = den = 0.0
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        num += float(np.sum((x - y) ** 2))
        den += float(np.sum(y ** 2))
    return float(np.sqrt(num / den))


def phase_spmm(n_node, n_edge, widths=(256, 40), seed=0):
    """SpMM and its VJP (the transposed SpMM of the backward) against
    scipy float64."""
    import scipy.sparse as sp

    from gnn_tail_generalization.data.synthetic import (
        fast_powerlaw_graph,
    )
    from gnn_tail_generalization.graph.core import (
        build_graph, standard_pipeline,
    )
    from gnn_tail_generalization.ops.spmm import spmm

    def fwd_and_vjp(g, x, ct, method):
        y, pull = jax.vjp(lambda x_: spmm(g, x_, method), x)
        return y, pull(ct)[0]

    run = jax.jit(fwd_and_vjp, static_argnums=3)
    rng = np.random.default_rng(seed)
    errs = {}
    e = standard_pipeline(fast_powerlaw_graph(n_node, n_edge, seed), n_node)
    w = rng.uniform(0.1, 1.0, e.shape[1]).astype(np.float32)
    g = build_graph(e, n_node, w)
    a = sp.csr_matrix((w.astype(np.float64), (e[1], e[0])),
                      shape=(n_node, n_node))
    for d in widths:
        x = rng.standard_normal((n_node, d)).astype(np.float32)
        ct = rng.standard_normal((n_node, d)).astype(np.float32)
        ref_y, ref_t = a @ x.astype(np.float64), a.T @ ct.astype(np.float64)
        for method, tol in (("gather", 1e-5), ("bf16_operands", 1e-2)):
            y, t = run(g, jnp.asarray(x), jnp.asarray(ct), method)
            for name, out, ref in (("fwd", y, ref_y), ("t", t, ref_t)):
                err = _rel_fro(np.asarray(out, np.float64), ref)
                key = f"{method}_{name}_d{d}"
                assert err <= tol, f"spmm {key}: rel err {err:.3e} > {tol}"
                errs[key] = f"{err:.2e}"
    return errs


def _records(argv):
    cols, rec = cli.main(list(argv))
    assert np.isfinite(rec).all(), f"non-finite records {rec}"
    return cols, rec


def phase_teacher(epochs=5, args=ARXIV_ARGS):
    cols, rec = _records([*args, "--train_which=TeacherGNN",
                          f"--epochs={epochs}", "--log_every=0"])
    loss = rec[0, :, cols.index("loss_train")]
    assert loss[-1] < loss[0], f"teacher loss did not fall: {loss}"
    return {"loss_first": f"{loss[0]:.4f}", "loss_last": f"{loss[-1]:.4f}",
            "acc_test_last": f"{rec[0, -1, cols.index('acc_test')]:.2f}"}


def _train_trace(loss_fn, tx, params, const, steps):
    """Parameters, loss and gradient (on the host) of each of ``steps``
    teacher train steps from ``params``."""
    vg = jax.jit(jax.value_and_grad(loss_fn))
    update = jax.jit(tx.update)
    opt_state = tx.init(params)
    out = []
    for i in range(steps):
        loss, grads = vg(params, jax.random.PRNGKey(i), const)
        out.append((params, float(loss), jax.device_get(grads)))
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    return out


def _gaps(loss_fn, tx, params, const, ref, place, grad_map=lambda g: g):
    """Per step against the reference trace ``ref``: the relative gap of
    the loss along this model's own train steps, and the relative
    Frobenius gap of its gradient at the reference's parameters of that
    step (``place`` puts them where this model runs). Adam turns rounding
    noise in near-zero gradients into full steps, so two trajectories
    drift apart; the gradient at shared parameters does not."""
    own = _train_trace(loss_fn, tx, params, const, len(ref))
    loss_gap = [abs(l - lr) / abs(lr)
                for (_, l, _), (_, lr, _) in zip(own, ref)]
    grad = jax.jit(jax.grad(loss_fn))
    grad_gap = [
        _rel_fro_tree(jax.device_get(grad_map(
            grad(place(p), jax.random.PRNGKey(i), const))), g)
        for i, (p, _, g) in enumerate(ref)]
    return loss_gap, grad_gap


def _fmt(xs):
    return [f"{x:.2e}" for x in xs]


def phase_gpu_vs_cpu(shape, steps=3):
    """The same train steps on the default device and on the CPU: the loss
    and the gradient, which the aggregation feeds forward and backward."""
    import bench

    from gnn_tail_generalization.data.datasets import prepare

    cfg, data = bench.build_raw_workload(**shape)
    cfg = dataclasses.replace(cfg, dropout=0.0, spmm_method="gather")
    loss_fn, params, tx, const = bench.make_framework_loss(
        cfg, prepare(data, cfg))

    cpu_dev, dev = jax.devices("cpu")[0], jax.devices()[0]
    with jax.default_matmul_precision("highest"):
        cpu = _train_trace(loss_fn, tx, *jax.device_put((params, const),
                                                        cpu_dev), steps)
    const_dev = jax.device_put(const, dev)

    def gaps(precision):
        with jax.default_matmul_precision(precision):
            return _gaps(loss_fn, tx, jax.device_put(params, dev), const_dev,
                         cpu, lambda p: jax.device_put(p, dev))

    loss_gap, grad_gap = gaps("highest")
    assert max(loss_gap) <= 1e-4 and max(grad_gap) <= 1e-4, (
        f"GPU vs CPU: loss gap {loss_gap}, gradient gap {grad_gap} > 1e-4")
    loss_def, grad_def = gaps("default")
    return {"loss_gap_highest": _fmt(loss_gap),
            "grad_gap_highest": _fmt(grad_gap),
            "loss_gap_default_info": _fmt(loss_def),
            "grad_gap_default_info": _fmt(grad_def)}


def phase_semlp(epochs=3, args=ARXIV_ARGS):
    cols, rec = _records([*args, "--train_which=SEMLP", f"--epochs={epochs}",
                          "--log_every=0"])
    return {"part2_loss_last": f"{rec[0, -1, cols.index('loss_train')]:.4f}",
            "part2_acc_test_last":
                f"{rec[0, -1, cols.index('acc_test')]:.2f}"}


def phase_linkpred(n_node, n_edge, n_feat, steps=4, batch_size=64 * 1024,
                   eval_pos=8192, seed=0):
    import bench_linkpred

    from gnn_tail_generalization.linkpred.model import (
        LinkPredConfig, train_linkpred,
    )

    e, split_edge, msg_edges = bench_linkpred.citation2_split(
        n_node, n_edge, eval_pos=eval_pos, seed=seed)
    x = jax.jit(lambda k: jax.random.normal(k, (n_node, n_feat)))(
        jax.random.PRNGKey(seed))
    cfg = LinkPredConfig(encoder="SAGE", predictor="DOT",
                         use_node_feats=True, train_node_emb=False,
                         eval_metric="mrr", num_neg=3, batch_size=batch_size)
    out = train_linkpred(cfg, x, e, n_node, epochs=1, runs=1, eval_steps=1,
                         seed=seed, split_edge=split_edge,
                         msg_edges=msg_edges, max_steps_per_epoch=steps)
    mrr = out["stats"]["test_mean"]
    assert np.isfinite(mrr), out["stats"]
    return {"msg_edges": int(msg_edges.shape[1]), "steps": steps,
            "mrr_test": f"{mrr:.4f}"}


def phase_multidevice(n_devices, shape, epochs=3, args=ARXIV_ARGS):
    """``main --n_devices`` trains the sharded teacher; then the sharded
    loss and gradient must track the single-device ones step for step
    (shared weights, dropout off)."""
    from gnn_tail_generalization.data.datasets import (
        prepare, prepare_sharded,
    )
    from gnn_tail_generalization.parallel.distgraph import shard_params

    import bench

    _records([*args, "--train_which=TeacherGNN", f"--epochs={epochs}",
              f"--n_devices={n_devices}", "--log_every=0"])

    cfg, data = bench.build_raw_workload(**shape)
    cfg = dataclasses.replace(cfg, dropout=0.0, spmm_method="gather")
    mesh = jax.make_mesh((n_devices,), ("graph",),
                         devices=jax.devices()[:n_devices])
    pd_d = prepare_sharded(data, cfg, mesh)
    n, npad = cfg.N_nodes, pd_d.graph.n_node_pad
    loss_d, params_d, tx, const_d = bench.make_framework_loss(
        dataclasses.replace(cfg, N_nodes=npad), pd_d)
    loss_s, _, _, const_s = bench.make_framework_loss(
        cfg, prepare(data, cfg))

    # the single-device weights are sliced from the sharded model's, which
    # takes them back with zero SE padding rows (||E||_F then matches the
    # unpadded table): both models share every weight
    def is_se(path):
        return any(getattr(p, "key", None) == "se" for p in path)

    def unpad(tree):
        return jax.tree_util.tree_map_with_path(
            lambda p, v: v[:n] if is_se(p) else v, tree)

    def pad(tree):
        return shard_params(mesh, jax.tree_util.tree_map_with_path(
            lambda p, v: jnp.pad(v, ((0, npad - n), (0, 0))) if is_se(p)
            else v, tree))

    params_s = jax.device_put(unpad(params_d), jax.devices()[0])
    single = _train_trace(loss_s, tx, params_s, const_s, 3)
    loss_gap, grad_gap = _gaps(loss_d, tx, pad(params_s), const_d, single,
                               pad, grad_map=unpad)
    assert max(loss_gap) <= 5e-3 and max(grad_gap) <= 5e-3, (
        f"sharded vs single: loss gap {loss_gap}, "
        f"gradient gap {grad_gap} > 5e-3")
    return {"n_devices": n_devices, "n_node_pad": npad,
            "loss_gap": _fmt(loss_gap), "grad_gap": _fmt(grad_gap)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1: the single-card phases; N>1: only the "
                         "N-device path and its single-device comparison")
    args = ap.parse_args(argv)
    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX's backend is {backend!r}")
    if len(jax.devices()) < args.devices:
        sys.exit(f"chip_smoke: {args.devices} devices asked, "
                 f"{len(jax.devices())} present")
    card = gpu_name_and_power_limit()
    print(card, flush=True)

    if args.devices > 1:
        phases = [("multidevice",
                   lambda: phase_multidevice(args.devices, ARXIV))]
    else:
        phases = [
            ("spmm", lambda: phase_spmm(ARXIV["n_node"], ARXIV["n_edge"])),
            ("teacher", phase_teacher),
            ("gpu_vs_cpu", lambda: phase_gpu_vs_cpu(ARXIV)),
            ("semlp", phase_semlp),
            ("linkpred", lambda: phase_linkpred(**CITATION2)),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        info = fn()
        peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0)
        print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s; "
              f"{json.dumps(info)}; peak device bytes {peak}; card: {card}",
              flush=True)

    dev = device_fields()
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["device_kind"],
        "count": dev["count"]}}))


if __name__ == "__main__":
    main()
