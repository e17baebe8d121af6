"""The trick-combination GCN backbone (TricksComb equivalent).

Reference parity: ``/root/reference/GNN_model/GCN.py:18-150``.

Layer plan (GCN.py:38-81):
- no residual trick (``has_residual_mlp == False``):
  conv0: feats->hidden (SE flag [0]); middle convs: hidden->hidden (SE [1]);
  last conv: hidden->num_classes (SE [2]); relu after every layer except the
  last.
- with a residual trick ('Jumping'/'Initial'/'Residual'/'Dense' substring):
  input MLP feats->hidden + relu first, ALL convs hidden->hidden with SE
  flag [1] (GCN.py:51-52), relu every layer, and a final hidden->num_classes
  Linear (or the Jumping aggregation) after the loop.

Per layer (GCN.py:109-131): feature dropout -> conv -> norm-if-any -> (collect
SE target) -> relu -> residual aggregation.

Faithfully preserved quirks (flagged, not silently "fixed"):
- norm layers are BUILT for substring matches but only APPLIED when
  type_trick is exactly a norm name (run_norm_if_any membership test,
  norm_tricks.py:146-150) — see nn/norms.py:norm_applies.
- graph-dropout subgraphs are computed but never reach the conv
  (GCN.py:92-115); set ``apply_graph_dropout=True`` to actually rewire.

``collect_SE`` == calling with ``want_les=True``: the concatenation of every
layer's post-norm pre-relu activations, detached (GCN.py:124-125,148-150) —
the SEMLP part-1 distillation target.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from . import module as nn
import jax
import jax.numpy as jnp

from ..graph.core import Graph
from . import graph_dropout as gd
from .dropout import FastDropout
from .gcn import GCNConv
from .norms import NormLayer, norm_applies, norm_kind_of, groupnorm_presets
from .residual import DenseConnection, initial_connection, residual_connection


def _contains_any(s: str, subs) -> bool:
    return any(t in s for t in subs)


class TricksCombBackbone(nn.Module):
    num_feats: int
    num_classes: int  # == dim_commonEmb after TeacherGNN rebinding
    dim_hidden: int
    num_layers: int
    n_node: int
    type_trick: str = ""
    res_alpha: float = 0.1
    layer_agg: str = "concat"
    dropout: float = 0.5  # feature dropout, args.dropout
    whetherHasSE: Tuple[int, int, int] = (0, 0, 0)
    node_norm_type: str = "n"
    skip_weight: Optional[float] = None
    num_groups: Optional[int] = None
    dataset: str = ""  # for GroupNorm presets
    type_model: str = "GCN"
    spmm_method: str = "gather"
    apply_graph_dropout: bool = False
    graph_dropout: float = 0.2
    layerwise_dropout: bool = False

    @property
    def has_residual_mlp(self) -> bool:
        return _contains_any(
            self.type_trick, ["Jumping", "Initial", "Residual", "Dense"]
        )

    def se_dim(self) -> int:
        """Output dim of collect_SE (concat of per-layer activations).

        num_layers == 1 non-residual: the single conv is built by the
        first-layer branch (feats -> dim_hidden), so the 'last layer is
        num_classes wide' rule does not apply — matching the reference's
        runtime shape (its forward also routes L=1 through the first-layer
        conv, GCN.py:31-44)."""
        if self.has_residual_mlp:
            return self.num_layers * self.dim_hidden
        if self.num_layers == 1:
            return self.dim_hidden
        return (self.num_layers - 1) * self.dim_hidden + self.num_classes

    def _norm_cfg(self):
        skip, groups = self.skip_weight, self.num_groups
        kind = norm_kind_of(self.type_trick)
        if kind in ("GroupNorm", "CombNorm") and (skip is None or groups is None):
            skip, groups = groupnorm_presets(
                self.dataset, self.type_model, self.num_layers
            )
        return kind, skip, groups

    @nn.compact
    def __call__(self, g: Graph, x, *, train: bool = False,
                 want_les: bool = False, g_last: Optional[Graph] = None):
        res_mlp = self.has_residual_mlp
        kind, skip_w, n_groups = self._norm_cfg()

        # --- per-layer graphs (graph-dropout tricks) ---
        graphs = [g] * self.num_layers
        if g_last is not None and train and not want_les:
            # loss-masked final-layer view (graph/core.loss_masked_view):
            # the caller guarantees nothing row-coupling consumes the
            # masked-out rows (train/loops.py gates)
            graphs[-1] = g_last
        if self.apply_graph_dropout and train:
            rng = self.make_rng("graph_dropout")
            masks = gd.per_layer_edge_masks(
                rng, gd.mask_view(g), self.type_trick, self.graph_dropout,
                self.num_layers, self.layerwise_dropout, train,
            )
            if masks is not None:
                graphs = [gd.apply_edge_mask(g, m) for m in masks]

        x_list: List = []
        les: List = []
        se_reg_all = None

        def drop(x):
            # halfword-threshold dropout (nn/dropout.py): same Bernoulli
            # marginals, 2x fewer random bits
            return FastDropout(self.dropout)(x, deterministic=not train)

        if res_mlp:
            x = drop(x)  # embedding_dropout == args.dropout (GCN.py:24)
            x = nn.Dense(self.dim_hidden)(x)
            x = nn.relu(x)
            x_list.append(x)

        for i in range(self.num_layers):
            if res_mlp:
                d_out, has_se = self.dim_hidden, self.whetherHasSE[1]
            elif i == 0:
                d_out, has_se = self.dim_hidden, self.whetherHasSE[0]
            elif i < self.num_layers - 1:
                d_out, has_se = self.dim_hidden, self.whetherHasSE[1]
            else:
                d_out, has_se = self.num_classes, self.whetherHasSE[2]

            x = drop(x)
            x, se_reg = GCNConv(
                out_feats=d_out,
                n_node=self.n_node,
                has_se=bool(has_se),
                spmm_method=self.spmm_method,
                name=f"conv_{i}",
            )(graphs[i], x)
            if se_reg is not None:
                se_reg_all = se_reg if se_reg_all is None else se_reg_all + se_reg

            if norm_applies(self.type_trick):
                norm_dim = (
                    self.dim_hidden if i < self.num_layers - 1 else self.num_classes
                )
                x = NormLayer(
                    kind=kind,
                    dim=norm_dim,
                    node_norm_type=self.node_norm_type,
                    skip_weight=skip_w,
                    num_groups=n_groups,
                    name=f"norm_{i}",
                )(x, train=train)

            if want_les:
                les.append(jax.lax.stop_gradient(x))

            if res_mlp or i < self.num_layers - 1:
                x = nn.relu(x)
            x_list.append(x)

            if _contains_any(self.type_trick, ["Initial", "Dense", "Residual"]):
                if "Residual" in self.type_trick:
                    x = residual_connection(x_list, self.res_alpha)
                elif "Initial" in self.type_trick:
                    x = initial_connection(x_list, self.res_alpha)
                elif "Dense" in self.type_trick:
                    x = DenseConnection(
                        out_dim=self.dim_hidden,
                        aggregation=self.layer_agg,
                        name=f"dense_agg_{i}",
                    )(x_list)

        x = drop(x)
        if res_mlp:
            if "Jumping" in self.type_trick:
                x = DenseConnection(
                    out_dim=self.num_classes,
                    aggregation=self.layer_agg,
                    name="jumping_agg",
                )(x_list)
            else:
                x = nn.Dense(self.num_classes, name="out_mlp")(x)

        les_cat = jnp.concatenate(les, axis=-1) if want_les else None
        return x, se_reg_all, les_cat
