"""matten_tpu — an equivariant message-passing framework in JAX.

A from-scratch JAX/XLA implementation of the capabilities of
wengroup/matten (an e3nn/PyG/Lightning-based tensor-field network for
tensorial crystal properties): irreps algebra, Clebsch-Gordan tensor
products, spherical-harmonic edge attributes, gate nonlinearities,
periodic radius graphs, padded ragged batching, and a full training /
prediction harness — static shapes for XLA, SPMD via jax.sharding.
"""

__version__ = "0.1.0"

from matten_tpu.ops.irreps import Irrep, Irreps

__all__ = ["Irrep", "Irreps", "__version__"]
