"""MLP builders: the ``getMLP`` stack and the residual-block MLP.

Reference parity:
- getMLP:      ``/root/reference/utils.py:885-908``
  [Linear, LayerNorm|BatchNorm, act, Dropout] x (n-1) + Linear (+opt Dropout);
  0/1 neurons -> identity, 2 neurons -> bare Linear.
- BlockResMLP: ``/root/reference/MLP_model/__init__.py:22-49``
  in_proj -> num_blocks x (x + MLP(x)) -> out_proj, GELU blocks with
  LayerNorm+Dropout, last block without trailing dropout.
"""
from __future__ import annotations

from typing import Callable, Sequence

from . import module as nn

# torch nn.Linear default init: kaiming_uniform(a=sqrt(5)) on W == uniform
# +-1/sqrt(fan_in); bias uniform +-1/sqrt(fan_in). We use Dense's defaults
# (lecun_normal) — initialization scheme is not part of behavioral parity,
# training targets are.


class MLP(nn.Module):
    """getMLP equivalent. ``neurons`` holds all n+1 dims input->output."""

    neurons: Sequence[int]
    activation: Callable = nn.gelu
    use_bias: bool = True
    dropout: float = 0.1
    last_dropout: bool = False
    normfun: str = "layernorm"  # layernorm | batchnorm

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        ns = list(self.neurons)
        if len(ns) <= 1:
            return x
        if len(ns) == 2:
            return nn.Dense(ns[1], use_bias=self.use_bias)(x)
        n = len(ns) - 1
        for i in range(n - 1):
            x = nn.Dense(ns[i + 1], use_bias=self.use_bias)(x)
            if self.normfun == "layernorm":
                x = nn.LayerNorm()(x)
            elif self.normfun == "batchnorm":
                x = nn.BatchNorm(use_running_average=not train, momentum=0.9)(x)
            x = self.activation(x)
            x = nn.Dropout(self.dropout, deterministic=not train)(x)
        x = nn.Dense(ns[n], use_bias=self.use_bias)(x)
        if self.last_dropout:
            x = nn.Dropout(self.dropout, deterministic=not train)(x)
        return x


class BlockResMLP(nn.Module):
    """Residual-block MLP (MLP_model/__init__.py:22-49).

    dim_model defaults to min(max(dims_in_out), 256); hidden to
    int(dim_model * 1.5) + 2. in/out projections are identities when dims
    already match.
    """

    dims_in_out: Sequence[int]
    num_blocks: int
    skip_conn_period: int = 2
    dim_model: int | None = None
    dim_hidden: int | None = None
    dropout: float = 0.1

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        d_in, d_out = self.dims_in_out
        dim_model = self.dim_model or min(max(self.dims_in_out), 256)
        dim_hidden = self.dim_hidden or int(dim_model * 1.5) + 2

        if dim_model != d_in:
            x = nn.Dense(dim_model)(x)
        neurons = (
            [dim_model] + [dim_hidden] * (self.skip_conn_period - 1) + [dim_model]
        )
        for b in range(self.num_blocks):
            last = b == self.num_blocks - 1
            h = MLP(
                neurons,
                dropout=self.dropout,
                last_dropout=not last,
            )(x, train=train)
            x = x + h
        if dim_model != d_out:
            x = nn.Dense(d_out)(x)
        return x
