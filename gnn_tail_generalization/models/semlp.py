"""Cold Brew student models: SEMLP (two-part MLP), StudentBaseMLP, GraphMLP.

Reference parity: ``/root/reference/MLP_model/__init__.py``.

SEMLP part 1 (51-99): MLP regressing node features -> teacher's concatenated
per-layer structural embeddings (collect_SE target); '2layer'/'3layer'/
'4layer' arch = [num_feats, 256 x (n-1), se_dim] with dropout_MLP, or the
BlockResMLP for 'residual'.

SEMLP part 2 (101-156): discovers top-K latent ("virtual") neighbors via
attention of the (detached, alpha-scaled) part-1 output against the teacher
SE table, then classifies MLP([x, replaced, part1_out]) -> classes.
Gradient flow matches the reference exactly: part-1 output is detached, so
part 2 trains only its own MLP and the two alpha scalars (init 1e-4);
``alphas[0]`` acts as a learnable attention temperature because the
replacement scores are computed AFTER scaling (MLP_model/__init__.py:107-108).

The per-node Python loop of ``replacement`` (143-156) is replaced by the
batched ops/topk_attention.py op: one matmul + lax.top_k.

GraphMLP (158-208): MLP + neighbor-contrastive loss against the r-th power
of the normalized adjacency, cropped to the batch.
"""
from __future__ import annotations

from typing import Optional

from ..nn import module as nn
import jax
import jax.numpy as jnp

from ..config import Config
from ..nn.mlp import MLP, BlockResMLP
from ..ops.topk_attention import latent_neighbor_replace


def _dim_model(cfg: Config) -> Optional[int]:
    return None if cfg.StudentMLP__dim_model == -1 else cfg.StudentBaseMLP.dim_model


class SEMLPPart1(nn.Module):
    """Feature -> teacher-SE regressor (MLP_model/__init__.py:76-99)."""

    cfg: Config
    se_dim: int

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        c = self.cfg
        if c.SEMLP_part1_arch == "residual":
            return BlockResMLP(
                dims_in_out=(c.num_feats, self.se_dim),
                dim_model=_dim_model(c),
                skip_conn_period=c.StudentBaseMLP.skip_conn_period,
                num_blocks=c.StudentBaseMLP.num_blocks,
            )(x, train=train)
        nlayer = int(c.SEMLP_part1_arch[0])
        neurons = [c.num_feats] + [256] * (nlayer - 1) + [self.se_dim]
        return MLP(neurons, dropout=c.dropout_MLP)(x, train=train)


class SEMLPPart2(nn.Module):
    """Classifier over [x, virtual-neighborhood, part1_out]
    (MLP_model/__init__.py:101-138).

    ``replace_fn``: latent-neighbor discovery op ``(le_guess, teacher_se,
    top_k) -> [B, se_dim]``; defaults to the single-device batched op.
    The sharded train loop injects ops.topk_attention's
    make_dist_latent_replace so a row-sharded SE table never gets
    replicated (static module attribute — a callable, never traced)."""

    cfg: Config
    replace_fn: Optional[object] = None

    @nn.compact
    def __call__(self, x, part1_out, teacher_se, *, train: bool = False):
        """``part1_out``: raw part-1 output for the batch (caller applies
        part 1; gradients are stopped here). ``teacher_se``: [N, se_dim]."""
        c = self.cfg
        replace = self.replace_fn or latent_neighbor_replace
        if c.SEMLP__downgrade_to_MLP:
            part2_in = x
        else:
            alphas = self.param(
                "alphas", lambda k: jnp.array([1e-4, 1e-4], jnp.float32)
            )
            p1 = jax.lax.stop_gradient(part1_out) * alphas[0]
            replaced = (
                jax.lax.stop_gradient(
                    replace(
                        jax.lax.stop_gradient(p1),
                        teacher_se,
                        c.SEMLP_topK_2_replace,
                    )
                )
                * alphas[1]
            )
            if c.SEMLP__include_part1out:
                part2_in = jnp.concatenate([x, replaced, p1], axis=-1)
            else:
                # reference line 113 double-indexes x here (bug); the intended
                # input is [x, replaced]
                part2_in = jnp.concatenate([x, replaced], axis=-1)

        if c.train_which == "StudentBaseMLP":
            return BlockResMLP(
                dims_in_out=(c.num_feats, c.num_classes_bkup),
                dim_model=_dim_model(c),
                skip_conn_period=c.StudentBaseMLP.skip_conn_period,
                num_blocks=c.StudentBaseMLP.num_blocks,
            )(part2_in, train=train)
        neurons = [part2_in.shape[-1], 256, c.num_classes_bkup]
        return MLP(neurons, dropout=c.dropout_MLP)(part2_in, train=train)


class StudentBaseMLP(nn.Module):
    """Thin BlockResMLP wrapper (MLP_model/__init__.py:3-20)."""

    cfg: Config

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        c = self.cfg
        return BlockResMLP(
            dims_in_out=tuple(c.StudentBaseMLP.dims_in_out),
            dim_model=_dim_model(c),
            skip_conn_period=c.StudentBaseMLP.skip_conn_period,
            num_blocks=c.StudentBaseMLP.num_blocks,
        )(x, train=train)


def cosine_sim(x, precision=jax.lax.Precision.HIGHEST):
    """Pairwise cosine similarity (MLP_model/__init__.py:200-208). Zero-norm
    rows are guarded (the reference NaNs on them; real bag-of-words data
    never has any)."""
    dis = jnp.matmul(x, x.T, precision=precision)
    nrm = jnp.maximum(jnp.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    return dis / (nrm @ nrm.T)


def neighbor_contrastive_loss(z, adj_pow_crop, tau):
    """GraphMLP NContrast loss (MLP_model/__init__.py:190-198) in fixed-shape
    form: rows whose numerator is 0 are excluded from the mean."""
    b = z.shape[0]
    eye = jnp.eye(b, dtype=z.dtype)
    simz = (1.0 - eye) * jnp.exp(cosine_sim(z) / tau)
    numer = jnp.sum(adj_pow_crop * simz, axis=1)
    denom = jnp.sum(simz, axis=1)
    nz = numer != 0
    logs = jnp.where(nz, jnp.log(jnp.where(nz, numer, 1.0) / denom), 0.0)
    cnt = jnp.maximum(jnp.sum(nz), 1)
    return -jnp.sum(logs) / cnt


class GraphMLP(nn.Module):
    """MLP_model/__init__.py:158-183. Returns (logits, z); the NContrast loss
    is computed by the train loop from z and the cropped adjacency power."""

    cfg: Config

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        c = self.cfg
        hidden = 256  # paper-reported (MLP_model/__init__.py:163-164)
        z = MLP([c.num_feats, hidden, hidden], dropout=0.6)(x, train=train)
        logits = nn.Dense(c.num_classes_bkup)(z)
        return logits, z
