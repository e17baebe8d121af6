"""nn/dropout.py: halfword-threshold dropout statistics and semantics."""
import numpy as np

import jax
import jax.numpy as jnp

from gnn_tail_generalization.nn.dropout import (
    FastDropout,
    fast_dropout_mask,
)


def test_mask_statistics_and_unbiasedness():
    keep = 0.9
    mask, realized = fast_dropout_mask(jax.random.PRNGKey(0), keep,
                                       (4096, 256))
    frac = float(jnp.mean(mask))
    # realized keep prob is the exact threshold used
    assert abs(realized - keep) < 1.0 / 65536 + 1e-9
    assert abs(frac - realized) < 0.005  # 1M draws, ~3 sigma
    # halves are independent: correlation between block 0 and block 1 cols
    a = np.asarray(mask[:, :128], float)
    b = np.asarray(mask[:, 128:], float)
    corr = np.corrcoef(a.reshape(-1), b.reshape(-1))[0, 1]
    assert abs(corr) < 0.01


def test_module_scaling_and_determinism():
    x = jnp.ones((512, 64))
    mod = FastDropout(0.5)
    y = mod.apply({}, x, deterministic=False,
                  rngs={"dropout": jax.random.PRNGKey(1)})
    # kept entries are scaled by 1/keep, dropped are 0
    vals = np.unique(np.asarray(y).round(6))
    assert set(vals) <= {0.0, np.float32(1.0 / 0.5).round(6)}
    # E[y] == x (unbiased)
    assert abs(float(jnp.mean(y)) - 1.0) < 0.05
    # deterministic mode is the identity
    y2 = mod.apply({}, x, deterministic=True)
    assert np.array_equal(np.asarray(y2), np.asarray(x))
    # rate 0 is the identity even in train mode
    y3 = FastDropout(0.0).apply({}, x, deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(1)})
    assert np.array_equal(np.asarray(y3), np.asarray(x))


def test_odd_shapes_fall_back():
    x = jnp.ones((33, 7))  # odd columns -> nn.Dropout fallback
    y = FastDropout(0.5).apply({}, x, deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(2)})
    assert y.shape == x.shape
    assert np.isfinite(np.asarray(y)).all()
