"""Observability: profiler traces, NaN guards, throughput counters.

The reference has essentially none of this (SURVEY.md section 5): wall-clock
prints and a dead PAPI block. Equivalents here:

- ``profile_trace``: jax.profiler trace context (view in TensorBoard /
  xprof) around any training region.
- ``checked``: jax.experimental.checkify wrapper with float checks — the
  debug-run equivalent of torch's anomaly detection; returns (err, out) and
  ``err.throw()``s on NaN/Inf with a located stack.
- ``assert_finite``: host-side pytree finiteness check for tests/loops.
- ``spmm_edges_per_sec``: the per-kernel edges/s counter used as the
  framework's canonical perf unit (BASELINE.md).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def profile_trace(logdir: str):
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def checked(fn, *, div: bool = True, nan: bool = True, inf: bool = True):
    """checkify-wrapped fn: returns g(*args) -> (err, out).

    checkify has no standalone inf set: nan_checks covers NaN AND Inf
    detection, so ``inf`` folds into ``nan`` (requesting either enables
    nan_checks) rather than being a silent no-op."""
    from jax.experimental import checkify

    checks = []
    if div:
        checks.append(checkify.div_checks)
    if nan or inf:
        checks.append(checkify.nan_checks)
    errors = frozenset(c for cs in checks for c in cs)
    return checkify.checkify(fn, errors=errors)


def assert_finite(tree: Any, name: str = "pytree") -> None:
    bad = []

    def visit(path, leaf):
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            if not bool(jnp.isfinite(leaf).all()):
                bad.append(jax.tree_util.keystr(path))

    jax.tree_util.tree_map_with_path(visit, tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def spmm_edges_per_sec(g, x, method: str = "gather", iters: int = 10) -> float:
    """Measured SpMM throughput in edges/s on the device ``x`` lives on."""
    from ..ops.spmm import spmm

    f = jax.jit(lambda g, x: spmm(g, x, method))
    f(g, x).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(g, x)
    out.block_until_ready()
    dt = (time.perf_counter() - t0) / iters
    return g.n_edge / dt
