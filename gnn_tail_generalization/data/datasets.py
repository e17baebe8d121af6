"""Dataset container and the node-classification preparation pipeline.

Reference parity: ``/root/reference/trainer_node_classification.py:616-670``
(load_data) — Planetoid public split with NormalizeFeatures, the Cora
first-600-train special split (630-636), symmetrize + de/re-self-loop edge
pipeline (655-662) — and ``utils.py:680-752`` (degree analysis + isolation
crafting, done in trainer.main before training).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import Config
from ..graph import analysis
from ..graph.core import build_graph, standard_pipeline, Graph


@dataclass
class NodeData:
    """Raw dataset: host numpy arrays, edge_index as loaded (directed ok)."""

    x: np.ndarray  # [N, F] float32
    y: np.ndarray  # [N] int64
    edge_index: np.ndarray  # [2, E]
    train_mask: np.ndarray  # [N] bool
    val_mask: Optional[np.ndarray]
    test_mask: Optional[np.ndarray]
    name: str = ""


@dataclass
class PreparedData:
    """Everything the train loops need, after the full preprocessing chain."""

    x: np.ndarray
    y: np.ndarray
    edge_index: np.ndarray  # crafted (isolation) edge list used for training
    edge_index_bkup: np.ndarray  # pre-crafting edge list
    train_mask: np.ndarray
    val_mask: Optional[np.ndarray]
    test_mask: np.ndarray
    train_idx: np.ndarray
    test_idx: np.ndarray
    splits: Optional[analysis.DegreeSplits]
    graph: Graph  # built from the crafted edge list

    @property
    def n_node(self) -> int:
        return self.x.shape[0]


def normalize_features(x: np.ndarray) -> np.ndarray:
    """Row-normalize to sum 1 (torch_geometric T.NormalizeFeatures used at
    trainer_node_classification.py:631)."""
    s = x.sum(axis=1, keepdims=True)
    s[s == 0] = 1.0
    return (x / s).astype(np.float32)


def apply_special_split(data: NodeData, cfg: Config) -> NodeData:
    """Cora special split: first 600 nodes train, rest test
    (trainer_node_classification.py:632-636)."""
    if "Cora" in data.name:
        n = data.x.shape[0]
        train = np.zeros(n, dtype=bool)
        train[:600] = True
        return dataclasses.replace(data, train_mask=train, test_mask=~train)
    return data


def prepare(data: NodeData, cfg: Config) -> PreparedData:
    """Full preprocessing: special split -> edge pipeline -> degree analysis
    -> isolation crafting -> device graph."""
    n = data.x.shape[0]
    data = apply_special_split(data, cfg)

    e = standard_pipeline(data.edge_index, n)

    test_mask = (
        data.test_mask if data.test_mask is not None else ~data.train_mask
    )

    splits = None
    e_crafted = e
    if cfg.do_deg_analyze:
        splits = analysis.degree_splits(n, e, cfg.use_special_split)
        if cfg.use_special_split:
            e_crafted, _ = analysis.craft_isolation(e, splits.zero_deg_mask)

    g = build_graph(e_crafted, n)

    return PreparedData(
        x=np.asarray(data.x, np.float32),
        y=np.asarray(data.y, np.int64),
        edge_index=e_crafted,
        edge_index_bkup=e,
        train_mask=data.train_mask,
        val_mask=data.val_mask,
        test_mask=test_mask,
        train_idx=np.where(data.train_mask)[0],
        test_idx=np.where(test_mask)[0],
        splits=splits,
        graph=g,
    )


def prepare_sharded(data: NodeData, cfg: Config, mesh, *,
                    axis: str = "graph", model_axis=None,
                    rb: int = 128) -> PreparedData:
    """Multi-chip variant of ``prepare``: same preprocessing chain, but the
    graph becomes a parallel.distgraph.DistGraph (row-sharded over the
    mesh's ``axis``) and x/y/masks are padded to n_node_pad and device_put
    row-sharded. The returned PreparedData feeds train_teacher unchanged —
    the model dispatches to the ring SpMM through ops.spmm.spmm.

    Padded rows carry zero features, label 0, and False in every mask, so
    they contribute to no loss, metric, or aggregation."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.distgraph import (
        build_dist_graph, global_put, pad_rows_np,
    )

    n = data.x.shape[0]
    data = apply_special_split(data, cfg)
    e = standard_pipeline(data.edge_index, n)
    test_mask = (
        data.test_mask if data.test_mask is not None else ~data.train_mask
    )
    splits = None
    e_crafted = e
    if cfg.do_deg_analyze:
        splits = analysis.degree_splits(n, e, cfg.use_special_split)
        if cfg.use_special_split:
            e_crafted, _ = analysis.craft_isolation(e, splits.zero_deg_mask)

    dg = build_dist_graph(e_crafted, n, mesh, axis=axis,
                          model_axis=model_axis, rb=rb,
                          with_edge_view=cfg.apply_graph_dropout)
    npad = dg.n_node_pad
    sh_m = NamedSharding(mesh, P(axis, model_axis))
    sh_v = NamedSharding(mesh, P(axis))

    def put_rows(a, sharding):
        return global_put(pad_rows_np(np.asarray(a), npad), sharding)

    if splits is not None:
        splits = dataclasses.replace(
            splits,
            large_deg_mask=put_rows(splits.large_deg_mask, sh_v),
            small_deg_mask=put_rows(splits.small_deg_mask, sh_v),
            zero_deg_mask=(
                None if splits.zero_deg_mask is None
                else put_rows(splits.zero_deg_mask, sh_v)
            ),
        )

    return PreparedData(
        x=put_rows(np.asarray(data.x, np.float32), sh_m),
        y=put_rows(np.asarray(data.y, np.int64), sh_v),
        edge_index=e_crafted,
        edge_index_bkup=e,
        train_mask=put_rows(data.train_mask, sh_v),
        val_mask=(None if data.val_mask is None
                  else put_rows(data.val_mask, sh_v)),
        test_mask=put_rows(test_mask, sh_v),
        train_idx=np.where(np.asarray(data.train_mask))[0],
        test_idx=np.where(np.asarray(test_mask))[0],
        splits=splits,
        graph=dg,
    )


def load_dataset(cfg: Config, data_root: Optional[str] = None,
                 which_run: int = 0) -> NodeData:
    """Registry mirroring load_data/load_ogbn
    (trainer_node_classification.py:570-670): real raw files when present
    under ``data_root``, otherwise a deterministic synthetic stand-in with
    the preset shapes. WebKB/Actor/Wikipedia re-split per run block
    (which_split = which_run // 10, trainer:645-651)."""
    if data_root is not None:
        try:
            if cfg.dataset in ("Cora", "Citeseer", "Pubmed"):
                from . import planetoid

                return planetoid.load_planetoid(data_root, cfg.dataset)
            if cfg.dataset == "ogbn-arxiv":
                from . import ogb

                return ogb.load_ogbn_arxiv(data_root)
            if cfg.dataset in ("TEXAS", "WISCONSIN", "CORNELL", "ACTOR",
                               "chameleon", "squirrel"):
                from . import webkb

                return webkb.load_webkb_like(
                    data_root, cfg.dataset, which_split=which_run // 10
                )
        except FileNotFoundError:
            pass
    known = ("Cora", "Citeseer", "Pubmed", "ogbn-arxiv", "TEXAS",
             "WISCONSIN", "CORNELL", "ACTOR", "chameleon", "squirrel", "")
    if cfg.dataset not in known:
        raise ValueError(
            f"unknown dataset {cfg.dataset!r}; choose one of {known[:-1]}"
        )
    from . import synthetic

    return synthetic.synthetic_planetoid(
        n_node=cfg.N_nodes or 2708,
        n_feat=cfg.num_feats or 1433,
        n_class=cfg.num_classes or 7,
        seed=0,
        name=f"synthetic-{cfg.dataset}" if cfg.dataset else "synthetic",
    )
