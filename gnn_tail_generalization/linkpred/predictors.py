"""Edge-score predictors: DOT / BIL / MLP / MLPDOT / MLPBIL / MLPCAT.

Reference parity: ``/root/reference/Link_prediction_model/layer.py:85-203``.
All operate on gathered endpoint embeddings [B, d] -> scores.
"""
from __future__ import annotations

from ..nn import module as nn
import jax.numpy as jnp


class DotPredictor(nn.Module):
    @nn.compact
    def __call__(self, x_i, x_j, *, train: bool = False):
        return jnp.sum(x_i * x_j, axis=-1)


class BilinearPredictor(nn.Module):
    """sum(W x_i * x_j) (layer.py:193-203)."""

    hidden_channels: int

    @nn.compact
    def __call__(self, x_i, x_j, *, train: bool = False):
        return jnp.sum(
            nn.Dense(self.hidden_channels, use_bias=False)(x_i) * x_j, axis=-1
        )


class MLPPredictor(nn.Module):
    """Hadamard -> MLP -> scalar (layer.py:85-106)."""

    hidden_channels: int
    num_layers: int
    dropout: float = 0.0
    out_channels: int = 1

    @nn.compact
    def __call__(self, x_i, x_j, *, train: bool = False):
        x = x_i * x_j
        for i in range(self.num_layers):
            out = (self.out_channels if i == self.num_layers - 1
                   else self.hidden_channels)
            x = nn.Dense(out)(x)
            if i < self.num_layers - 1:
                x = nn.relu(x)
                x = nn.Dropout(self.dropout, deterministic=not train)(x)
        return x[..., 0]


class MLPCatPredictor(nn.Module):
    """Symmetrized concat MLP (layer.py:108-134)."""

    hidden_channels: int
    num_layers: int
    dropout: float = 0.0
    out_channels: int = 1

    @nn.compact
    def __call__(self, x_i, x_j, *, train: bool = False):
        x1 = jnp.concatenate([x_i, x_j], axis=-1)
        x2 = jnp.concatenate([x_j, x_i], axis=-1)
        for i in range(self.num_layers):
            out = (self.out_channels if i == self.num_layers - 1
                   else self.hidden_channels)
            lin = nn.Dense(out)
            x1, x2 = lin(x1), lin(x2)
            if i < self.num_layers - 1:
                x1, x2 = nn.relu(x1), nn.relu(x2)
                do = nn.Dropout(self.dropout, deterministic=not train)
                x1, x2 = do(x1), do(x2)
        return ((x1 + x2) / 2)[..., 0]


class MLPDotPredictor(nn.Module):
    """Shared-tower MLP (relu+dropout after EVERY layer) then dot
    (layer.py:136-156)."""

    hidden_channels: int
    num_layers: int
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x_i, x_j, *, train: bool = False):
        for _ in range(self.num_layers):
            lin = nn.Dense(self.hidden_channels)
            x_i, x_j = nn.relu(lin(x_i)), nn.relu(lin(x_j))
            do = nn.Dropout(self.dropout, deterministic=not train)
            x_i, x_j = do(x_i), do(x_j)
        return jnp.sum(x_i * x_j, axis=-1)


class MLPBilPredictor(nn.Module):
    """Shared-tower MLP then bilinear dot (layer.py:158-180)."""

    hidden_channels: int
    num_layers: int
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x_i, x_j, *, train: bool = False):
        for _ in range(self.num_layers):
            lin = nn.Dense(self.hidden_channels)
            x_i, x_j = nn.relu(lin(x_i)), nn.relu(lin(x_j))
            do = nn.Dropout(self.dropout, deterministic=not train)
            x_i, x_j = do(x_i), do(x_j)
        return jnp.sum(
            nn.Dense(self.hidden_channels, use_bias=False)(x_i) * x_j, axis=-1
        )


def create_predictor(name: str, hidden_channels: int, num_layers: int,
                     dropout: float):
    """Factory (model.py:306-319)."""
    name = name.upper()
    if name == "DOT":
        return DotPredictor()
    if name == "BIL":
        return BilinearPredictor(hidden_channels)
    if name == "MLP":
        return MLPPredictor(hidden_channels, num_layers, dropout)
    if name == "MLPCAT":
        return MLPCatPredictor(hidden_channels, num_layers, dropout)
    if name == "MLPDOT":
        return MLPDotPredictor(hidden_channels, num_layers, dropout)
    if name == "MLPBIL":
        return MLPBilPredictor(hidden_channels, num_layers, dropout)
    raise ValueError(name)
