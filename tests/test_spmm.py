import numpy as np
import jax
import jax.numpy as jnp

from gnn_tail_generalization.graph import core
from gnn_tail_generalization.ops.spmm import spmm, spmm_normalized


def random_graph(rng, n=50, e=300):
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    g = core.build_graph(np.stack([src, dst]), n, edge_weight=w)
    dense = np.zeros((n, n), dtype=np.float64)
    np.add.at(dense, (dst, src), w)
    return g, dense


def test_spmm_gather_matches_dense_reference(rng):
    g, dense = random_graph(rng)
    x = rng.normal(size=(50, 16)).astype(np.float32)
    y = spmm(g, jnp.asarray(x), "gather")
    np.testing.assert_allclose(np.asarray(y), dense @ x, rtol=1e-4, atol=1e-4)


def test_spmm_grad_is_transpose(rng):
    g, dense = random_graph(rng)
    x = rng.normal(size=(50, 8)).astype(np.float32)
    ct = rng.normal(size=(50, 8)).astype(np.float32)

    def f(x):
        return jnp.vdot(spmm(g, x, "gather"), jnp.asarray(ct))

    dx = jax.grad(f)(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(dx), dense.T @ ct, rtol=1e-4, atol=1e-4)


def test_spmm_edge_weight_grad_is_sddmm(rng):
    from gnn_tail_generalization.ops.spmm import spmm_edge_grad

    g, dense = random_graph(rng)
    x = jnp.asarray(rng.normal(size=(50, 8)).astype(np.float32))
    ct = jnp.asarray(rng.normal(size=(50, 8)).astype(np.float32))

    def f(w):
        return jnp.vdot(spmm_edge_grad(g, x, w, "gather"), ct)

    dw = jax.grad(f)(g.edge_weight)
    expect = np.sum(
        np.asarray(ct)[np.asarray(g.receivers)]
        * np.asarray(x)[np.asarray(g.senders)],
        axis=-1,
    )
    expect[g.n_edge:] = 0.0  # padding-slot cotangents are zeroed
    np.testing.assert_allclose(np.asarray(dw), expect, rtol=1e-4, atol=1e-4)


def test_spmm_normalized_matches_manual(rng):
    n, e = 30, 120
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    g = core.build_graph(np.stack([src, dst]), n)
    x = rng.normal(size=(n, 4)).astype(np.float32)

    dout = np.maximum(np.bincount(src, minlength=n), 1).astype(np.float64)
    din = np.maximum(np.bincount(dst, minlength=n), 1).astype(np.float64)
    a = np.zeros((n, n))
    np.add.at(a, (dst, src), 1.0)
    expect = (a @ (x * dout[:, None] ** -0.5)) * din[:, None] ** -0.5

    y = spmm_normalized(g, jnp.asarray(x), "both", method="gather")
    np.testing.assert_allclose(np.asarray(y), expect, rtol=1e-4, atol=1e-4)


def test_spmm_jit_under_vmap_free(rng):
    g, dense = random_graph(rng)
    x = jnp.asarray(rng.normal(size=(50, 16)).astype(np.float32))
    y = jax.jit(lambda x: spmm(g, x))(x)
    np.testing.assert_allclose(np.asarray(y), dense @ np.asarray(x), rtol=1e-4, atol=1e-4)


def test_edge_grad_padding_weights_masked(rng):
    """Caller-provided edge weights (e.g. sigmoid(0)=0.5 at init) must NOT
    aggregate through the static-shape padding self-loops at the last
    node (round-2 review finding)."""
    from gnn_tail_generalization.graph import core
    from gnn_tail_generalization.ops.spmm import spmm_edge_grad

    n = 10
    src = np.asarray([0, 1, 2, 3])
    dst = np.asarray([4, 4, 5, 6])
    g = core.build_graph(np.stack([src, dst]), n,
                         pad_multiple=8)  # 4 padding edges at (9 -> 9)
    assert g.e_pad > g.n_edge
    x = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    w = jnp.full((g.e_pad,), 0.5, jnp.float32)
    y = spmm_edge_grad(g, x, w, "gather")
    np.testing.assert_allclose(np.asarray(y)[9], 0.0, atol=1e-6)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (dst, src), 0.5)
    np.testing.assert_allclose(np.asarray(y), dense @ np.asarray(x),
                               rtol=1e-5, atol=1e-6)


def test_se_dim_single_layer():
    from gnn_tail_generalization.nn.backbone import TricksCombBackbone

    bb = TricksCombBackbone(num_feats=10, num_classes=7, dim_hidden=16,
                            num_layers=1, n_node=20, dropout=0.0)
    g_np = np.stack([np.arange(20), (np.arange(20) + 1) % 20])
    from gnn_tail_generalization.graph import core

    g = core.build_graph(g_np, 20)
    x = jnp.zeros((20, 10))
    vs = bb.init(jax.random.PRNGKey(0), g, x, train=False)
    _, _, les = bb.apply(vs, g, x, train=False, want_les=True)
    assert les.shape[1] == bb.se_dim() == 16
