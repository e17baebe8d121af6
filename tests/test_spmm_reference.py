"""The plain SpMM against an independent scipy float64 reference, and the
choice of path in ops/spmm.py."""
import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from gnn_tail_generalization.data.synthetic import fast_powerlaw_graph
from gnn_tail_generalization.graph import core
from gnn_tail_generalization.ops import spmm as spmm_mod
from gnn_tail_generalization.ops.spmm import SPMM_METHODS, spmm

N = 300

# f32 only reorders the sums; bf16 operands round each x entry to 8 bits
TOL = {"gather": 1e-5, "bf16_operands": 1e-2}


def _graph(skew: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if skew == "uniform":
        e = np.stack([rng.integers(0, N, 6 * N), rng.integers(0, N, 6 * N)])
    else:  # power-law in-degrees: a few hub rows hold most edges
        e = fast_powerlaw_graph(N, 6 * N, seed, exponent=0.8)
    e = core.standard_pipeline(e, N)
    w = rng.uniform(0.1, 1.0, e.shape[1]).astype(np.float32)
    g = core.build_graph(e, N, w)
    a = sp.csr_matrix((w.astype(np.float64), (e[1], e[0])), shape=(N, N))
    return g, a


def _rel_fro(y, ref):
    y = np.asarray(y, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("skew", ["uniform", "powerlaw"])
@pytest.mark.parametrize("method", ["gather", "bf16_operands"])
@pytest.mark.parametrize("d", [1, 40, 256])
@pytest.mark.parametrize("direction", ["forward", "gradient"])
def test_spmm_matches_scipy_float64(skew, method, d, direction):
    g, a = _graph(skew)
    rng = np.random.default_rng(d)
    x = rng.standard_normal((N, d)).astype(np.float32)
    if direction == "forward":
        out = jax.jit(spmm, static_argnums=2)(g, jnp.asarray(x), method)
        ref = a @ x.astype(np.float64)
    else:  # the custom VJP runs the transposed SpMM: dx = A^T ct
        ct = rng.standard_normal((N, d)).astype(np.float32)
        out = jax.grad(lambda z: jnp.vdot(spmm(g, z, method),
                                          jnp.asarray(ct)))(jnp.asarray(x))
        ref = a.T @ ct.astype(np.float64)
    assert out.dtype == jnp.float32
    assert _rel_fro(out, ref) <= TOL[method]


def test_power_law_graph_is_skewed():
    """The power-law case above really has hub rows (else it tests nothing
    the uniform case does not)."""
    _, a = _graph("powerlaw")
    deg = np.diff(a.indptr)
    assert deg.max() > 10 * np.median(deg)


def _jaxpr_of(g, method, direction="forward"):
    """The jaxpr of one spmm call, or of its VJP (the transposed SpMM)."""
    x = jnp.ones((N, 4), jnp.float32)
    if direction == "forward":
        f = lambda g, x: spmm(g, x, method)
    else:
        f = lambda g, x: jax.grad(lambda z: spmm(g, z, method).sum())(x)
    jaxpr = str(jax.make_jaxpr(f)(g, x))
    assert "pallas" not in jaxpr
    return jaxpr


@pytest.mark.parametrize("method", SPMM_METHODS)
@pytest.mark.parametrize("direction", ["forward", "gradient"])
def test_spmm_method_choice(method, direction):
    """Both methods gather and segment-sum, forward and in the VJP; only
    bf16_operands rounds the gathered operands to bfloat16."""
    jaxpr = _jaxpr_of(_graph("uniform")[0], method, direction)
    assert "scatter-add" in jaxpr and "dot_general" not in jaxpr
    assert ("bf16" in jaxpr) == (method == "bf16_operands")


def test_unknown_spmm_method_is_refused():
    g, _ = _graph("uniform")
    for old in ("auto", "dense", "pallas", "pallas_bf16", "sparse"):
        with pytest.raises(ValueError, match="unknown spmm method"):
            spmm(g, jnp.ones((N, 4)), old)


def test_no_spmm_method_reaches_pallas():
    """No method lowers to a Pallas call or an interpreter, on any graph:
    the module imports no Pallas at all."""
    import inspect

    src = inspect.getsource(spmm_mod)
    assert "pallas" not in src and "interpret" not in src
    g, _ = _graph("uniform")
    for m in SPMM_METHODS:
        _jaxpr_of(g, m)
