"""Normalization trick zoo for the teacher GCN.

Reference parity: ``/root/reference/GNN_model/norm_tricks.py``
- pair_norm  (20-30):  center columns, divide by mean row norm
- mean_norm  (33-41):  center columns
- node_norm  (44-92):  per-row n|v|m|srv|pr variants
- group_norm (95-120): softmax soft-clustering + grouped BatchNorm + skip
- comb_norm  (9-17):   group_norm then node_norm
- BatchNorm1d: plain batch norm (appendNormLayer, 131-132)
- per-dataset GroupNorm presets (reset_weight_GroupNorm, 153-206)
"""
from __future__ import annotations

from typing import Optional

from . import module as nn
import jax.numpy as jnp


def pair_norm(x):
    """norm_tricks.py:25-30."""
    x = x - jnp.mean(x, axis=0)
    rownorm_mean = jnp.sqrt(1e-6 + jnp.mean(jnp.sum(x**2, axis=1)))
    return x / rownorm_mean


def mean_norm(x):
    """norm_tricks.py:38-41."""
    return x - jnp.mean(x, axis=0)


def node_norm(x, node_norm_type: str = "n", unbiased: bool = False,
              eps: float = 1e-5, power_root: int = 2):
    """norm_tricks.py:53-84. torch.var(unbiased=False) == ddof 0."""
    ddof = 1 if unbiased else 0
    if node_norm_type == "n":
        mean = jnp.mean(x, axis=1, keepdims=True)
        std = jnp.sqrt(jnp.var(x, axis=1, keepdims=True, ddof=ddof) + eps)
        return (x - mean) / std
    if node_norm_type == "v":
        std = jnp.sqrt(jnp.var(x, axis=1, keepdims=True, ddof=ddof) + eps)
        return x / std
    if node_norm_type == "m":
        return x - jnp.mean(x, axis=1, keepdims=True)
    if node_norm_type == "srv":
        std = jnp.sqrt(jnp.var(x, axis=1, keepdims=True, ddof=ddof) + eps)
        return x / jnp.sqrt(std)
    if node_norm_type == "pr":
        std = jnp.sqrt(jnp.var(x, axis=1, keepdims=True, ddof=ddof) + eps)
        return x / std ** (1.0 / power_root)
    raise ValueError(node_norm_type)


class GroupNorm(nn.Module):
    """Differentiable group norm (norm_tricks.py:95-120).

    num_groups==1 degenerates to plain BatchNorm; otherwise soft-cluster via
    softmax(Linear(x)), batch-norm the concatenated scaled copies, fold the
    groups back by summation, and add with skip_weight.
    torch BatchNorm1d(momentum=0.3) == nn.BatchNorm momentum 0.7.
    """

    dim_hidden: int
    num_groups: int
    skip_weight: float

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        bn = nn.BatchNorm(use_running_average=not train, momentum=0.7,
                          epsilon=1e-5)
        if self.num_groups == 1:
            x_temp = bn(x)
        else:
            score = nn.softmax(
                nn.Dense(self.num_groups, use_bias=True)(x), axis=1
            )  # [N, G]
            # [N, G*D]: group-g block is score[:, g] * x
            x_temp = (score[:, :, None] * x[:, None, :]).reshape(
                x.shape[0], self.num_groups * self.dim_hidden
            )
            x_temp = bn(x_temp)
            x_temp = x_temp.reshape(
                x.shape[0], self.num_groups, self.dim_hidden
            ).sum(axis=1)
        return x + x_temp * self.skip_weight


def groupnorm_presets(dataset: str, type_model: str, num_layers: int):
    """(skip_weight, num_groups) — reset_weight_GroupNorm, norm_tricks.py:153-206."""
    if dataset == "Citeseer" or "CV" in dataset:
        skip = (0.001 if num_layers < 6 else 0.005) if type_model in ("GAT", "GCN") \
            else (0.0005 if num_layers < 60 else 0.002)
    elif dataset == "ogbn-arxiv":
        skip = (0.001 if num_layers < 6 else 0.005) if type_model in ("GAT", "GCN") \
            else (0.0005 if num_layers < 60 else 0.002)
    elif dataset == "Pubmed":
        if type_model == "GCN":
            skip = 0.001 if num_layers < 6 else 0.01
        elif type_model == "GAT":
            skip = 0.005 if num_layers < 6 else 0.01
        else:
            skip = 0.05
    elif dataset == "Cora":
        if type_model == "GCN":
            skip = 0.001 if num_layers < 6 else 0.03
        elif type_model == "GAT":
            skip = 0.001 if num_layers < 6 else 0.01
        else:
            skip = 0.01 if num_layers < 60 else 0.005
    elif dataset == "CoauthorCS":
        # norm_tricks.py:187-191 — the reachable CoauthorCS branch (the
        # later flat-0.005 elif that also lists CoauthorCS is dead code in
        # the reference)
        if type_model in ("GAT", "GCN"):
            skip = 0.001 if num_layers < 6 else 0.03
        else:
            # deviation (PARITY.md): the reference also mutates
            # args.epochs = 500 here as a hidden side effect; we keep the
            # epoch budget in Config.epochs — pass --epochs=500 explicitly
            skip = 0.001 if num_layers < 10 else 0.5
    elif dataset in ("CoauthorPhysics", "AmazonComputers",
                     "AmazonPhoto", "TEXAS", "WISCONSIN", "CORNELL"):
        skip = 0.005
    else:
        raise NotImplementedError(dataset)
    num_groups = 5 if dataset == "Pubmed" else 10
    return skip, num_groups


class NormLayer(nn.Module):
    """One entry of layers_norm; dispatches on the trick string the way
    appendNormLayer/run_norm_if_any do (norm_tricks.py:130-150)."""

    kind: str  # BatchNorm|PairNorm|NodeNorm|MeanNorm|GroupNorm|CombNorm|None
    dim: int
    node_norm_type: str = "n"
    skip_weight: Optional[float] = None
    num_groups: Optional[int] = None

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        k = self.kind
        if k == "BatchNorm":
            return nn.BatchNorm(use_running_average=not train, momentum=0.9,
                                epsilon=1e-5)(x)
        if k == "PairNorm":
            return pair_norm(x)
        if k == "NodeNorm":
            return node_norm(x, self.node_norm_type)
        if k == "MeanNorm":
            return mean_norm(x)
        if k == "GroupNorm":
            return GroupNorm(self.dim, self.num_groups, self.skip_weight)(
                x, train=train
            )
        if k == "CombNorm":
            x = GroupNorm(self.dim, self.num_groups, self.skip_weight)(
                x, train=train
            )
            return node_norm(x, self.node_norm_type)
        return x


def norm_kind_of(type_trick: str) -> str:
    """Which norm layer a trick string selects (appendNormLayer order,
    norm_tricks.py:130-143; substring match like AcontainsB)."""
    for k in ("BatchNorm", "PairNorm", "NodeNorm", "MeanNorm", "GroupNorm",
              "CombNorm"):
        if k in type_trick:
            return k
    return "None"


def norm_applies(type_trick: str) -> bool:
    """run_norm_if_any (norm_tricks.py:146-150) only applies the norm when the
    trick string is EXACTLY one of the norm names — combined strings like
    'Initial+BatchNorm' build the layers but skip them at forward time.

    That is the literal reference behavior; the best-config table emits
    combined strings like 'NoResNodeNorm', which therefore run un-normed.
    We preserve it: exact-match applies."""
    return type_trick in ("BatchNorm", "PairNorm", "NodeNorm", "MeanNorm",
                          "GroupNorm", "CombNorm")
