"""nn/module.py: naming and state rules, and its layers against flax.linen
(present where the tests run, never imported by the package)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gnn_tail_generalization.nn import module as nn


def _same_tree(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype


def _x(shape=(16, 12), seed=0):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                       jnp.float32)


@pytest.mark.parametrize("kw", [{}, {"use_bias": False}])
def test_dense_matches_flax(kw):
    linen = pytest.importorskip("flax.linen")
    x = _x()
    ours = nn.Dense(7, **kw).init(jax.random.PRNGKey(0), x)
    theirs = linen.Dense(7, **kw).init(jax.random.PRNGKey(0), x)
    _same_tree(ours, theirs)
    # lecun-normal kernel: variance 1 / fan_in, like flax's
    k = np.asarray(ours["params"]["kernel"])
    assert abs(k.var() * x.shape[1] - 1.0) < 0.5
    np.testing.assert_allclose(
        nn.Dense(7, **kw).apply(theirs, x),
        linen.Dense(7, **kw).apply(theirs, x), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_flax(train):
    linen = pytest.importorskip("flax.linen")
    x = _x() * 3.0 + 1.0
    kw = dict(momentum=0.7, epsilon=1e-5)
    ours = nn.BatchNorm(use_running_average=not train, **kw)
    theirs = linen.BatchNorm(use_running_average=not train, **kw)
    v_ours = ours.init(jax.random.PRNGKey(0), x)
    v_theirs = theirs.init(jax.random.PRNGKey(0), x)
    _same_tree(v_ours, v_theirs)
    jax.tree.map(np.testing.assert_array_equal, v_ours, v_theirs)
    y1, s1 = ours.apply(v_theirs, x, mutable=["batch_stats"])
    y2, s2 = theirs.apply(v_theirs, x, mutable=["batch_stats"])
    np.testing.assert_allclose(y1, y2, rtol=1e-6, atol=1e-6)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6),
                 s1, s2)


def test_batchnorm_eval_without_mutable_state():
    x = _x()
    bn = nn.BatchNorm(use_running_average=True)
    v = bn.init(jax.random.PRNGKey(0), x)
    y = bn.apply(v, x)  # running stats: mean 0, var 1 -> identity-ish
    np.testing.assert_allclose(y, x / np.sqrt(1 + 1e-5), rtol=1e-6)
    with pytest.raises(ValueError, match="not mutable"):
        nn.BatchNorm(use_running_average=False).apply(v, x)


def test_layernorm_matches_flax():
    linen = pytest.importorskip("flax.linen")
    x = _x() * 2.0 - 0.5
    v_ours = nn.LayerNorm().init(jax.random.PRNGKey(0), x)
    v_theirs = linen.LayerNorm().init(jax.random.PRNGKey(0), x)
    _same_tree(v_ours, v_theirs)
    v = jax.tree.map(lambda p: p + 0.25, v_theirs)
    np.testing.assert_allclose(nn.LayerNorm().apply(v, x),
                               linen.LayerNorm().apply(v, x),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_dropout_matches_flax_semantics(rate):
    linen = pytest.importorskip("flax.linen")
    x = _x((200, 64)) + 3.0
    rngs = {"dropout": jax.random.PRNGKey(1)}
    # deterministic: identity in both
    np.testing.assert_array_equal(
        nn.Dropout(rate).apply({}, x, deterministic=True),
        linen.Dropout(rate).apply({}, x, deterministic=True))
    ours = np.asarray(nn.Dropout(rate).apply({}, x, deterministic=False,
                                             rngs=rngs))
    theirs = np.asarray(linen.Dropout(rate).apply({}, x, deterministic=False,
                                                  rngs=rngs))
    for y in (ours, theirs):
        kept = y != 0
        if rate < 1.0:  # kept entries are scaled by 1 / keep
            np.testing.assert_allclose(y[kept], np.asarray(x)[kept]
                                       / (1 - rate), rtol=1e-6)
        assert abs(kept.mean() - (1 - rate)) < 0.02


def test_compact_names_setup_names_and_reuse():
    class Inner(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(3)(nn.Dense(4)(x))

    class Outer(nn.Module):
        def setup(self):
            self.head = nn.Dense(2)
            self.blocks = [Inner(), Inner()]

        def __call__(self, x):
            for b in self.blocks:
                x = b(x)
            return self.head(x)

    class Twice(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(5, name="proj")(nn.Dense(5)(x))

        def again(self, x):
            return self(self(x))  # second call reuses every name

    x = _x((4, 5))
    p = Outer().init(jax.random.PRNGKey(0), x)["params"]
    assert sorted(p) == ["blocks_0", "blocks_1", "head"]
    assert sorted(p["blocks_0"]) == ["Dense_0", "Dense_1"]
    t = Twice().init(jax.random.PRNGKey(0), x, method=Twice.again)["params"]
    assert sorted(t) == ["Dense_0", "proj"]


def test_make_rng_streams_differ_by_path_and_call():
    class Two(nn.Module):
        @nn.compact
        def __call__(self, x):
            a = nn.Dropout(0.5)(x, deterministic=False)
            b = nn.Dropout(0.5)(x, deterministic=False)
            return a, b

    x = jnp.ones((64, 64))
    a, b = Two().apply({}, x, rngs={"dropout": jax.random.PRNGKey(0)})
    assert not np.array_equal(np.asarray(a), np.asarray(b))
    a2, _ = Two().apply({}, x, rngs={"dropout": jax.random.PRNGKey(0)})
    np.testing.assert_array_equal(np.asarray(a), np.asarray(a2))
    with pytest.raises(ValueError, match="dropout"):
        Two().apply({}, x)


def test_missing_param_is_an_error():
    with pytest.raises(KeyError, match="kernel"):
        nn.Dense(3).apply({"params": {}}, _x((2, 4)))
