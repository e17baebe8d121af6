"""Baseline-embedding generation API.

Reference parity: ``/root/reference/Link_prediction_baseline/run_airport.py:382-548``
(gen_baseline_embs): build the graph from edge_index, degree-bucket one-hot
features, train DGI/EGI/VGAE, return frozen embeddings for the
link-prediction model's input layer
(``trainer_link_prediction.py:391-393``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import jax.numpy as jnp

from ..graph.core import build_graph, standard_pipeline


def degree_bucketing(edge_index: np.ndarray, n_node: int,
                     max_degree: int = 32) -> np.ndarray:
    """One-hot of min(degree, max_degree-1) (run_airport.py degree_bucketing)."""
    deg = np.bincount(np.asarray(edge_index)[1], minlength=n_node)
    deg = np.minimum(deg, max_degree - 1)
    x = np.zeros((n_node, max_degree), np.float32)
    x[np.arange(n_node), deg] = 1.0
    return x


def gen_baseline_embs(edge_index: np.ndarray, n_node: int, alg: str,
                      x: Optional[np.ndarray] = None, hidden_dim: int = 64,
                      epochs: int = 50, seed: int = 0, log_every: int = 0):
    """Train the chosen self-supervised model, return frozen [N, D] embs."""
    e = standard_pipeline(edge_index, n_node)
    g = build_graph(e, n_node)
    if x is None:
        # reference run_airport.py:46-48 overrides max_degree with n_hidden
        # so the degree one-hot has the model's hidden width
        x = degree_bucketing(e, n_node, max_degree=hidden_dim)
    xd = jnp.asarray(np.asarray(x, np.float32))

    if alg == "DGI":
        from .dgi import train_dgi

        embs, _ = train_dgi(g, xd, hidden_dim, epochs=epochs, seed=seed,
                            log_every=log_every)
    elif alg == "EGI":
        from .egi import train_egi

        embs, _ = train_egi(g, xd, hidden_dim, epochs=epochs, seed=seed,
                            log_every=log_every, edge_index=e)
    elif alg == "VGAE":
        from .vgae import train_vgae

        embs, _ = train_vgae(g, xd, hidden_dim, epochs=epochs, seed=seed,
                             log_every=log_every)
    else:
        raise ValueError(alg)
    return np.asarray(embs)
