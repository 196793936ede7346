"""Equivariant neural-network modules (nn.module) over the data-dict pytree."""

from matten_tpu.nn.common import freeze_irreps, irreps_dict
from matten_tpu.nn.embedding import SpeciesEmbedding, EdgeLengthEmbedding
from matten_tpu.nn.edge_geometry import SphericalHarmonicEdgeAttrs, with_edge_vectors
from matten_tpu.nn.gate import Gate, NormActivation, ActivationInfo
from matten_tpu.nn.norm import IrrepsBatchNorm, IrrepsInstanceNorm
from matten_tpu.nn.conv import PointConv, PointConvWithActivation
from matten_tpu.nn.nodewise import NodewiseLinear, NodewiseReduce, NodewiseSelect
from matten_tpu.nn.sequential import Sequential

__all__ = [
    "freeze_irreps",
    "irreps_dict",
    "SpeciesEmbedding",
    "EdgeLengthEmbedding",
    "SphericalHarmonicEdgeAttrs",
    "with_edge_vectors",
    "Gate",
    "NormActivation",
    "ActivationInfo",
    "IrrepsBatchNorm",
    "IrrepsInstanceNorm",
    "PointConv",
    "PointConvWithActivation",
    "NodewiseLinear",
    "NodewiseReduce",
    "NodewiseSelect",
    "Sequential",
]
