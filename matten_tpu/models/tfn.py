"""TFN model assembly: hparams dict -> layer stack with static irreps threading.

Re-architecture of the reference model factories
(model_factory/tfn_scalar_tensor.py:103-193, tfn_atomic_tensor.py:103-198,
model_factory/utils.py:13-91): the layer order and hyperparameter surface
are preserved; the assembly threads each module's `irreps_out` into the next
module's `irreps_in` at construction time so every CG path table is static.

Layer stack:
  SpeciesEmbedding -> SphericalHarmonicEdgeAttrs -> EdgeLengthEmbedding
  -> num_layers x PointConvWithActivation -> PointConv (no activation)
  -> NodewiseLinear head
  -> [scalar/tensor model only] NodewiseReduce pooling
then the model head: an equivariant Linear into the symmetry-adapted irreps
of `output_formula` (graph-level model), or the NodewiseLinear head maps
directly into those irreps (atomic model), with optional Cartesian readout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax.numpy as jnp

from matten_tpu.data import keys as K
from matten_tpu.nn.common import freeze_irreps, normal_initializer
from matten_tpu.nn.conv import PointConv, PointConvWithActivation
from matten_tpu.nn.edge_geometry import SphericalHarmonicEdgeAttrs
from matten_tpu.nn.embedding import EdgeLengthEmbedding, SpeciesEmbedding
from matten_tpu.nn.module import Module
from matten_tpu.nn.nodewise import NodewiseLinear, NodewiseReduce
from matten_tpu.nn.sequential import Sequential, validate_chain
from matten_tpu.ops.cartesian import cartesian_tensor_map
from matten_tpu.ops.irreps import Irreps
from matten_tpu.ops.tensor_product import LinearPlan

OUT_FIELD = "model_output"


def _resolve_avg_num_neighbors(hparams, dataset_hparams) -> Optional[float]:
    v = hparams.get("average_num_neighbors", None)
    if isinstance(v, str) and v.lower() == "auto":
        return dataset_hparams["average_num_neighbors"]
    return v


def create_tfn_backbone(
    hparams: Dict[str, Any],
    dataset_hparams: Dict[str, Any],
    head_irreps: Irreps,
    pooling: Optional[str],
) -> Sequential:
    irreps = freeze_irreps({K.POSITIONS: Irreps("1o")})
    layers = []

    graph_axis = hparams.get("graph_parallel_axis", None)
    graph_shard_mode = hparams.get("graph_parallel_mode", "edge")
    gather_axis = (
        graph_axis if graph_shard_mode in ("node", "node_ring") else None
    )

    m = SpeciesEmbedding(
        irreps_in=irreps,
        allowed_species=tuple(int(z) for z in dataset_hparams["allowed_species"]),
        embedding_dim=hparams.get("species_embedding_dim", 16),
        use_atom_feats=hparams.get("use_atom_feats", False),
        atom_feats_dim=dataset_hparams.get("atom_feats_size") or 0,
        use_global_feats=hparams.get("use_global_feats", False),
        global_feats_dim=dataset_hparams.get("global_feats_size") or 0,
        name="species_embedding",
    )
    layers.append(m)
    irreps = m.irreps_out

    m = SphericalHarmonicEdgeAttrs(
        irreps_in=irreps,
        irreps_edge_sh=Irreps(hparams["irreps_edge_sh"]),
        gather_axis=gather_axis,
        require_position_gradients=hparams.get("require_position_gradients", False),
        name="spharm_edges",
    )
    layers.append(m)
    irreps = m.irreps_out

    m = EdgeLengthEmbedding(
        irreps_in=irreps,
        num_basis=hparams.get("num_radial_basis", 8),
        start=hparams.get("radial_basis_start", 0.0),
        end=hparams.get("radial_basis_end", 5.0),
        basis=hparams.get("radial_basis_type", "bessel"),
        gather_axis=gather_axis,
        name="radial_basis",
    )
    layers.append(m)
    irreps = m.irreps_out

    avg_num_neighbors = _resolve_avg_num_neighbors(hparams, dataset_hparams)
    conv_irreps = Irreps(hparams["conv_layer_irreps"])
    for i in range(hparams.get("num_layers", 3)):
        m = PointConvWithActivation(
            irreps_in=irreps,
            conv_layer_irreps=conv_irreps,
            fc_num_hidden_layers=hparams.get("invariant_layers", 2),
            fc_hidden_size=hparams.get("invariant_neurons", 32),
            avg_num_neighbors=avg_num_neighbors,
            activation_type=hparams.get("nonlinearity_type", "gate"),
            normalization=hparams.get("normalization", None),
            graph_axis=graph_axis,
            graph_shard_mode=graph_shard_mode,
            name=f"layer{i}_convnet",
        )
        layers.append(m)
        irreps = m.irreps_out

    m = PointConv(
        irreps_in=irreps,
        conv_layer_irreps=conv_irreps,
        fc_num_hidden_layers=hparams.get("invariant_layers", 2),
        fc_hidden_size=hparams.get("invariant_neurons", 32),
        avg_num_neighbors=avg_num_neighbors,
        graph_axis=graph_axis,
        graph_shard_mode=graph_shard_mode,
        name="conv_layer_last",
    )
    layers.append(m)
    irreps = m.irreps_out

    m = NodewiseLinear(
        irreps_in=irreps,
        irreps_out_field=head_irreps,
        field=K.NODE_FEATURES,
        out_field=OUT_FIELD,
        name="conv_to_output_hidden",
    )
    layers.append(m)
    irreps = m.irreps_out

    if pooling is not None:
        m = NodewiseReduce(
            irreps_in=irreps,
            field=OUT_FIELD,
            out_field=OUT_FIELD,
            reduce=pooling,
            axis=graph_axis if graph_shard_mode in ("node", "node_ring") else None,
            name="output_pooling",
        )
        layers.append(m)

    validate_chain(layers)

    # per-layer NaN/Inf anomaly detection at DEBUG level (reference
    # model_factory/utils.py:85-87)
    from matten_tpu.utils.logging import get_log_level

    if get_log_level() == "DEBUG":
        from matten_tpu.utils.anomaly import DetectAnomaly

        wrapped = []
        for layer in layers:
            wrapped.append(layer)
            wrapped.append(DetectAnomaly(label=getattr(layer, "name", "") or ""))
        layers = wrapped
    return Sequential(layers=tuple(layers))


def _target_irreps(formula: str) -> Irreps:
    if formula == "scalar":
        return Irreps("0e")
    return cartesian_tensor_map(formula).irreps


class ScalarTensorModel(Module):
    """Graph-level scalar/tensor prediction (reference ScalarTensorModel,
    model_factory/tfn_scalar_tensor.py:32-100): backbone + equivariant
    Linear head into the target irreps, optional Cartesian readout.

    Multi-task: with `scalar_target_names` set, additional per-name 0e
    Linear heads read the pooled hidden features and the model returns a
    {target_name: prediction} dict (the reference's BaseModel multi-task
    loss surface, model/model.py:234-274, which its shipped decode()
    restricts to one task — here fully wired)."""

    backbone: Sequential
    hidden_irreps: Irreps  # conv_to_output_hidden irreps (head input)
    output_formula: str = "ijkl=jikl=klij"
    output_format: str = "irreps"
    tensor_target_name: str = "elastic_tensor_full"
    scalar_target_names: Tuple[str, ...] = ()

    def __call__(
        self, data: Dict[str, jnp.ndarray], use_running_average: bool = False
    ):
        data = self.backbone(data, use_running_average=use_running_average)
        x = data[OUT_FIELD]  # [num_graphs, hidden_dim]
        plan = LinearPlan(Irreps(self.hidden_irreps), _target_irreps(self.output_formula))
        w = self.param("w_out", normal_initializer(), (plan.weight_numel,))
        out = plan.apply(x, w)
        if self.output_format == "cartesian" and self.output_formula != "scalar":
            out = cartesian_tensor_map(self.output_formula).to_cartesian(out)
        if not self.scalar_target_names:
            return out
        preds = {self.tensor_target_name: out}
        scalar_plan = LinearPlan(Irreps(self.hidden_irreps), Irreps("0e"))
        for name in self.scalar_target_names:
            ws = self.param(f"w_{name}", normal_initializer(), (scalar_plan.weight_numel,))
            preds[name] = scalar_plan.apply(x, ws)
        return preds


class AtomicTensorModel(Module):
    """Per-node tensor prediction (reference AtomicTensorModel,
    model_factory/tfn_atomic_tensor.py:30-100): the backbone head maps
    directly into the target irreps; no pooling, no extra head."""

    backbone: Sequential
    output_formula: str = "ij=ji"
    output_format: str = "irreps"

    def __call__(
        self, data: Dict[str, jnp.ndarray], use_running_average: bool = False
    ) -> jnp.ndarray:
        data = self.backbone(data, use_running_average=use_running_average)
        out = data[OUT_FIELD]  # [num_nodes, target_dim]
        if self.output_format == "cartesian" and self.output_formula != "scalar":
            out = cartesian_tensor_map(self.output_formula).to_cartesian(out)
        return out


def create_scalar_tensor_model(
    hparams: Dict[str, Any], dataset_hparams: Dict[str, Any]
) -> ScalarTensorModel:
    hidden = Irreps(hparams["conv_to_output_hidden_irreps_out"])
    backbone = create_tfn_backbone(
        hparams,
        dataset_hparams,
        head_irreps=hidden,
        pooling=hparams.get("reduce", "mean"),
    )
    return ScalarTensorModel(
        backbone=backbone,
        hidden_irreps=hidden,
        output_formula=hparams.get("output_formula", "ijkl=jikl=klij").lower(),
        output_format=hparams.get("output_format", "irreps"),
        tensor_target_name=hparams.get("tensor_target_name", "elastic_tensor_full"),
        scalar_target_names=tuple(hparams.get("scalar_target_names", ()) or ()),
    )


def create_atomic_tensor_model(
    hparams: Dict[str, Any], dataset_hparams: Dict[str, Any]
) -> AtomicTensorModel:
    formula = hparams.get("output_formula", "ij=ji").lower()
    backbone = create_tfn_backbone(
        hparams,
        dataset_hparams,
        head_irreps=_target_irreps(formula),
        pooling=None,
    )
    return AtomicTensorModel(
        backbone=backbone,
        output_formula=formula,
        output_format=hparams.get("output_format", "irreps"),
    )
