"""Edge displacement vectors and spherical-harmonic edge attributes.

Port of the reference's lazy edge-geometry computation
(with_edge_vectors, nn/_nequip.py:214-268) and SphericalHarmonicEdgeAttrs
(nn/_nequip.py:131-176). Padded (masked-out) edges produce zero vectors and
zero SH attributes of degree > 0 (the l=0 component is masked explicitly so
dummy edges carry no message weight at all).
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp

from matten_tpu.data import keys as K
from matten_tpu.nn.common import IrrepsDictT, freeze_irreps, irreps_dict, merge_irreps
from matten_tpu.nn.module import Module
from matten_tpu.ops.irreps import Irreps
from matten_tpu.ops.spherical_harmonics import spherical_harmonics


def with_edge_vectors(
    data: Dict[str, jnp.ndarray], require_position_gradients: bool = False
) -> Dict[str, jnp.ndarray]:
    """Compute edge displacement vectors + lengths (idempotent).

    vec(e) = pos[dst] - pos[src] + shift(e) @ cell[batch[src]]
    with src = edge_index[0] (convolution center), dst = edge_index[1]
    (neighbor) — the reference's convention (data/data.py:296-303,
    nn/_nequip.py:236-262). Differentiable w.r.t. pos and cell.

    `require_position_gradients=True` makes the no-positional-gradients
    contract of host-precomputed EDGE_VECTORS loud: a consumer that needs
    d(output)/d(pos) — a future force/stress head — must NOT silently use
    precomputed vectors (they are constants w.r.t. positions), so their
    presence raises. Configure the datamodule with
    `precompute_edge_vectors: false` for such heads.
    """
    if K.EDGE_VECTORS in data:
        if require_position_gradients:
            raise ValueError(
                "precomputed EDGE_VECTORS are constants w.r.t. positions, but "
                "this model requires position gradients "
                "(require_position_gradients=True). Set the datamodule knob "
                "precompute_edge_vectors=false so edge vectors are computed "
                "in-graph from POSITIONS."
            )
        if K.EDGE_LENGTH not in data:
            data = dict(data)
            data[K.EDGE_LENGTH] = jnp.linalg.norm(data[K.EDGE_VECTORS], axis=-1)
        return data
    data = dict(data)
    pos = data[K.POSITIONS]
    src, dst = data[K.EDGE_INDEX]
    # node-sharded graph parallelism: src ids are global and index the
    # halo-gathered positions; dst ids are local (see parallel/, keys.py)
    pos_src = data.get("pos_full", pos)
    vec = pos[dst] - pos_src[src]
    if K.CELL in data:
        cell = data[K.CELL].reshape(-1, 3, 3)
        shift = data[K.EDGE_CELL_SHIFT]
        batch = data.get(K.BATCH)
        if cell.shape[0] > 1:
            # edges stay within one graph, so batch[dst] == batch[src]; use
            # the locally indexed side
            edge_cell = cell[batch[dst]]
            vec = vec + jnp.einsum("ei,eij->ej", shift, edge_cell)
        else:
            vec = vec + jnp.einsum("ei,ij->ej", shift, cell[0])
    if K.EDGE_MASK in data:
        vec = vec * data[K.EDGE_MASK][:, None].astype(vec.dtype)
    data[K.EDGE_VECTORS] = vec
    data[K.EDGE_LENGTH] = jnp.linalg.norm(vec, axis=-1)
    return data


def _maybe_gather_positions(data, axis, initializing: bool):
    """Halo-gather positions across the node-sharding axis (idempotent).

    Node-sharded models: edge source ids are global and need the full
    position array for edge-vector computation.
    """
    if axis is None or K.POS_FULL in data or K.EDGE_VECTORS in data:
        return data
    import jax

    data = dict(data)
    if initializing:
        data[K.POS_FULL] = data[K.POSITIONS]
    else:
        data[K.POS_FULL] = jax.lax.all_gather(data[K.POSITIONS], axis, tiled=True)
    return data


class SphericalHarmonicEdgeAttrs(Module):
    """edge_attrs = Y_l(r_hat) for l in `irreps_edge_sh` (component norm).

    Reference: SphericalHarmonicEdgeAttrs (nn/_nequip.py:131-176) with
    normalize=True, normalization="component".
    """

    irreps_in: IrrepsDictT
    irreps_edge_sh: Irreps  # e.g. Irreps("0e+1o+2e+3o+4e")
    out_field: str = K.EDGE_ATTRS
    # node-sharding axis: positions are halo-gathered before edge vectors
    gather_axis: str = None
    # loud contract: error out if precomputed EDGE_VECTORS would silently
    # zero a needed d(output)/d(positions) (see with_edge_vectors)
    require_position_gradients: bool = False

    @property
    def irreps_out(self) -> IrrepsDictT:
        return merge_irreps(self.irreps_in, {self.out_field: Irreps(self.irreps_edge_sh)})

    def __call__(self, data: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
        data = _maybe_gather_positions(data, self.gather_axis, self.is_initializing())
        data = with_edge_vectors(
            data, require_position_gradients=self.require_position_gradients
        )
        vec = data[K.EDGE_VECTORS]
        sh = spherical_harmonics(
            Irreps(self.irreps_edge_sh), vec, normalize=True, normalization="component"
        )
        if K.EDGE_MASK in data:
            # zero the l=0 channel of dummy edges too (Y_0 would be 1)
            sh = sh * data[K.EDGE_MASK][:, None].astype(sh.dtype)
        data[self.out_field] = sh
        return data
