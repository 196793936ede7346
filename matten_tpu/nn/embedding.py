"""Species and edge-length embeddings.

Reference: SpeciesEmbedding / EdgeLengthEmbedding (nn/embedding.py:12,158).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from matten_tpu.data import keys as K
from matten_tpu.nn.common import IrrepsDictT, merge_irreps
from matten_tpu.nn.edge_geometry import with_edge_vectors
from matten_tpu.nn.module import Dense, Module
from matten_tpu.nn.radial import soft_one_hot_linspace
from matten_tpu.ops.irreps import Irreps


def atomic_number_map(allowed_species: Tuple[int, ...]) -> np.ndarray:
    """Lookup table mapping Z -> species index (-1 for unsupported).

    Reference: _AtomicNumberToIndex (nn/embedding.py:206-246), generalized
    to a 0-based table over 0..max_Z so it is a single jnp take.
    """
    allowed = sorted(int(z) for z in allowed_species)
    table = np.full(max(allowed) + 2, -1, dtype=np.int32)
    for i, z in enumerate(allowed):
        table[z] = i
    return table


class SpeciesEmbedding(Module):
    """Atomic number -> one-hot node_attrs [N, S] and node_features [N, D].

    node_attrs = one_hot(species_index); node_features = Dense(node_attrs)
    (torch.nn.Linear in the reference, nn/embedding.py:85-110; here a
    Dense with bias). Padded nodes get species 0 but are masked downstream.
    """

    irreps_in: IrrepsDictT
    allowed_species: Tuple[int, ...]
    embedding_dim: int = 16
    use_atom_feats: bool = False
    atom_feats_dim: int = 0
    # per-crystal features broadcast to that crystal's nodes and concatenated
    # (functional extension of the reference's global_feats hand-off, whose
    # in-repo consumption path is dead code)
    use_global_feats: bool = False
    global_feats_dim: int = 0

    @property
    def num_species(self) -> int:
        return len(self.allowed_species)

    @property
    def irreps_out(self) -> IrrepsDictT:
        feats_dim = (
            self.embedding_dim
            + (self.atom_feats_dim if self.use_atom_feats else 0)
            + (self.global_feats_dim if self.use_global_feats else 0)
        )
        return merge_irreps(
            self.irreps_in,
            {
                K.NODE_ATTRS: Irreps(f"{self.num_species}x0e"),
                K.NODE_FEATURES: Irreps(f"{feats_dim}x0e"),
            },
        )

    def __call__(self, data: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
        data = dict(data)
        if K.SPECIES_INDEX in data:
            idx = data[K.SPECIES_INDEX]
        else:
            table = jnp.asarray(atomic_number_map(self.allowed_species))
            z = jnp.clip(data[K.ATOMIC_NUMBERS], 0, table.shape[0] - 1)
            idx = table[z]
            data[K.SPECIES_INDEX] = idx
        idx = jnp.clip(idx, 0, self.num_species - 1)
        attrs = jax.nn.one_hot(idx, self.num_species, dtype=data[K.POSITIONS].dtype)
        if K.NODE_MASK in data:
            attrs = attrs * data[K.NODE_MASK][:, None].astype(attrs.dtype)
        embed = Dense(self.embedding_dim, name="linear")(attrs)
        if self.use_atom_feats:
            embed = jnp.concatenate([embed, data[K.ATOM_FEATS]], axis=-1)
        if self.use_global_feats:
            per_node = data[K.GLOBAL_FEATS][data[K.BATCH]]
            if K.NODE_MASK in data:
                per_node = per_node * data[K.NODE_MASK][:, None].astype(per_node.dtype)
            embed = jnp.concatenate([embed, per_node], axis=-1)
        data[K.NODE_ATTRS] = attrs
        data[K.NODE_FEATURES] = embed
        return data


class NodeAttrsFromEdgeAttrs(Module):
    """Node attributes as a segment reduction of edge attributes.

    Reference: NodeAttrsFromEdgeAttrs (nn/embedding.py:114-160).
    """

    irreps_in: IrrepsDictT
    field: str = K.EDGE_ATTRS
    out_field: str = K.NODE_ATTRS
    reduce: str = "mean"

    @property
    def irreps_out(self) -> IrrepsDictT:
        from matten_tpu.nn.common import irreps_dict

        return merge_irreps(
            self.irreps_in, {self.out_field: irreps_dict(self.irreps_in)[self.field]}
        )

    def __call__(self, data: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
        from matten_tpu.ops.scatter import scatter_mean, scatter_sum

        data = dict(data)
        _, dst = data[K.EDGE_INDEX]
        num_nodes = data[K.POSITIONS].shape[0]
        x = data[self.field]
        if self.reduce == "mean":
            out = scatter_mean(x, dst, num_nodes, weights=data.get(K.EDGE_MASK))
        else:
            if K.EDGE_MASK in data:
                x = x * data[K.EDGE_MASK][:, None].astype(x.dtype)
            out = scatter_sum(x, dst, num_nodes)
        data[self.out_field] = out
        return data


class EdgeLengthEmbedding(Module):
    """Edge length -> radial basis embedding [E, num_basis].

    bessel basis with hard (0, end) window, scaled by sqrt(num_basis) for
    unit second moment (reference nn/embedding.py:185-203). Dummy edges have
    zero length and produce all-zero embeddings via the window.
    """

    irreps_in: IrrepsDictT
    num_basis: int = 8
    start: float = 0.0
    end: float = 5.0
    basis: str = "bessel"
    cutoff: bool = True
    out_field: str = K.EDGE_EMBEDDING
    gather_axis: str = None  # node-sharding axis (see edge_geometry)

    @property
    def irreps_out(self) -> IrrepsDictT:
        return merge_irreps(self.irreps_in, {self.out_field: Irreps(f"{self.num_basis}x0e")})

    def __call__(self, data: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
        from matten_tpu.nn.edge_geometry import _maybe_gather_positions

        data = _maybe_gather_positions(data, self.gather_axis, self.is_initializing())
        data = with_edge_vectors(data)
        emb = soft_one_hot_linspace(
            data[K.EDGE_LENGTH],
            start=self.start,
            end=self.end,
            number=self.num_basis,
            basis=self.basis,
            cutoff=self.cutoff,
        )
        emb = emb * np.sqrt(self.num_basis)
        if K.EDGE_MASK in data:
            emb = emb * data[K.EDGE_MASK][:, None].astype(emb.dtype)
        data[self.out_field] = emb
        return data
