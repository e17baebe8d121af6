"""Times the plain SpMM paths on one device.

  spmm          gather + sorted ``segment_sum`` (f32, and bf16 operands with
                f32 sums), forward and transposed, d=256 and d=40, at the
                ogbn-arxiv shape: ms per call, chained in one jitted loop
  dense         a dense ``[N, N]`` matmul against the gather path, forward
                + VJP in f32 "highest", at 1,024 to 8,192 nodes
  teacher       the full teacher train step (``bench.time_step``), f32 and
                bf16 operands, each timed twice in alternation

Prints one JSON line per part, each with the device and, on a GPU, the
card's name and power limit.

Usage:  python tools/spmm_probe.py [--small] [--parts spmm,dense,teacher]
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gnn_tail_generalization.data.synthetic import fast_powerlaw_graph  # noqa: E402
from gnn_tail_generalization.graph.core import (  # noqa: E402
    build_graph, standard_pipeline,
)
from gnn_tail_generalization.ops.spmm import spmm  # noqa: E402
from gnn_tail_generalization.utils.device import device_fields  # noqa: E402

ARXIV = (169_343, 1_166_243)


def loop_ms(apply, x, iters=20, reps=5):
    """Median ms per ``apply``, ``iters`` calls chained in one jitted loop."""
    f = jax.jit(lambda x: jax.lax.fori_loop(0, iters, lambda i, c: apply(c), x))
    jax.block_until_ready(f(x))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3 / iters


def _graph(n, n_edge, seed=0):
    """A power-law graph with row-stochastic weights (chained calls stay
    bounded)."""
    e = standard_pipeline(fast_powerlaw_graph(n, n_edge, seed), n)
    deg_in = np.bincount(e[1], minlength=n).astype(np.float32)
    return e, (1.0 / deg_in[e[1]]).astype(np.float32)


def part_spmm(n, n_edge):
    e, w = _graph(n, n_edge)
    g = build_graph(e, n, w)
    x_rng = np.random.default_rng(0)
    out = {"n_node": n, "n_edge": int(e.shape[1])}
    for d in (256, 40):
        x = jnp.asarray(x_rng.standard_normal((n, d)).astype(np.float32))
        for name, gg in (("fwd", g), ("t", g.transpose())):
            for m in ("gather", "bf16_operands"):
                out[f"{m}_{name}_d{d}_ms"] = loop_ms(
                    lambda c, gg=gg, m=m: spmm(gg, c, m), x)
    return out


def part_dense(sizes=(1024, 2708, 4096, 8192)):
    out = {}
    x_rng = np.random.default_rng(0)
    for n in sizes:
        e, w = _graph(n, 2 * n, seed=1)
        g = build_graph(e, n, w)
        a_np = np.zeros((n, n), np.float32)
        np.add.at(a_np, (e[1], e[0]), w)
        a = jnp.asarray(a_np)
        hi = jax.lax.Precision.HIGHEST
        paths = {"dense": lambda z: jnp.matmul(a, z, precision=hi),
                 "gather": lambda z: spmm(g, z, "gather")}
        for d in (64, 256):
            x = jnp.asarray(x_rng.standard_normal((n, d)).astype(np.float32))
            for name, f in paths.items():
                def fwd_bwd(c, f=f):
                    y, pull = jax.vjp(f, c)
                    return pull(y)[0]
                out[f"n{n}_e{e.shape[1]}_d{d}_{name}_fwdbwd_ms"] = loop_ms(
                    fwd_bwd, x)
    return out


def part_teacher(n, n_edge):
    import bench

    from gnn_tail_generalization.data.datasets import prepare

    cfg0, data = bench.build_raw_workload(n_node=n, n_edge=n_edge)
    pd = prepare(data, cfg0)
    out = {}
    for _ in range(2):
        for m in ("gather", "bf16_operands"):
            cfg = dataclasses.replace(cfg0, spmm_method=m)
            step, p, o, c = bench.make_framework_step(cfg, pd)
            out.setdefault(f"{m}_step_ms", []).append(
                bench.time_step(step, p, o, c) * 1e3)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="a 2,000-node graph and 256..512-node dense sizes")
    ap.add_argument("--parts", default="spmm,dense,teacher")
    args = ap.parse_args(argv)
    n, n_edge = (2000, 14000) if args.small else ARXIV
    parts = {"spmm": lambda: part_spmm(n, n_edge),
             "dense": lambda: part_dense((256, 512) if args.small else
                                         (1024, 2708, 4096, 8192)),
             "teacher": lambda: part_teacher(n, n_edge)}
    dev = device_fields()
    for name in args.parts.split(","):
        print(json.dumps({"part": name, "device": dev, **parts[name]()}),
              flush=True)


if __name__ == "__main__":
    main()
