"""TeacherGNN — the Cold Brew teacher wrapper.

Reference parity: ``/root/reference/GNN_model/GNN_normalizations.py:9-65``.
- rebinds num_classes -> dim_commonEmb (== num_classes unless has_proj2class,
  utils.py:613-616)
- optional featureless mode: x * 0 (change_to_featureless) or learnable input
  embeddings of dim_learnable_input
- heads: proj2class / proj2linkp (both identity by default)
- ``get_3_embs`` returns commonEmb / classifier view / linkp view; the mask
  slicing happens in the train loop here (pure-function style).
"""
from __future__ import annotations

from ..nn import module as nn

from ..config import Config
from ..graph.core import Graph
from ..nn.backbone import TricksCombBackbone
from ..nn.mlp import MLP


def backbone_from_config(cfg: Config) -> TricksCombBackbone:
    return TricksCombBackbone(
        num_feats=cfg.num_feats,
        num_classes=cfg.dim_commonEmb,
        dim_hidden=cfg.dim_hidden,
        num_layers=cfg.num_layers,
        n_node=cfg.N_nodes,
        type_trick=cfg.type_trick,
        res_alpha=cfg.res_alpha,
        layer_agg=cfg.layer_agg,
        dropout=cfg.dropout,
        whetherHasSE=tuple(cfg.TeacherGNN.whetherHasSE),
        node_norm_type=cfg.node_norm_type,
        skip_weight=cfg.skip_weight,
        num_groups=cfg.num_groups,
        dataset=cfg.dataset,
        type_model=cfg.type_model,
        spmm_method=cfg.spmm_method,
        apply_graph_dropout=cfg.apply_graph_dropout,
        graph_dropout=cfg.graph_dropout,
        layerwise_dropout=cfg.layerwise_dropout,
    )


class TeacherGNN(nn.Module):
    cfg: Config

    def setup(self):
        c = self.cfg
        self.backbone = backbone_from_config(c)
        if c.dim_learnable_input > 0:
            self.input_embs = self.param(
                "input_embs",
                lambda k, s: 0.001 * nn.initializers.normal(1.0)(k, s),
                (c.N_nodes, c.dim_learnable_input),
            )
        if c.has_proj2class:
            self.proj2class = MLP(list(c.TeacherGNN.neurons_proj2class))
        else:
            self.proj2class = None

    def __call__(self, g: Graph, x, *, train: bool = False,
                 want_les: bool = False, g_last: Graph | None = None):
        """Returns (commonEmb, emb4classi_full, se_reg_all, les).

        ``g_last``: optional loss-masked final-layer view
        (graph/core.loss_masked_view) — train-mode perf optimization."""
        c = self.cfg
        if c.TeacherGNN.change_to_featureless:
            x = x * 0
        if c.dim_learnable_input > 0:
            x = self.input_embs
        common, se_reg_all, les = self.backbone(
            g, x, train=train, want_les=want_les, g_last=g_last
        )
        if self.proj2class is not None:
            classi = self.proj2class(common, train=train)
        else:
            classi = common
        return common, classi, se_reg_all, les

    def collect_se(self, g: Graph, x, *, train: bool = False):
        """Concatenated per-layer embeddings (GCN.py:148-150)."""
        _, _, _, les = self(g, x, train=train, want_les=True)
        return les

    def se_dim(self) -> int:
        return backbone_from_config(self.cfg).se_dim()
