"""TFN point convolution — the message-passing core.

Re-architecture of the reference's PointConv / PointConvWithActivation
(nn/conv.py:26-215): self-connection and node-wise mixing are
species-conditioned fully-connected tensor products; the per-edge message is
a radial-MLP-weighted uvu CG tensor product of gathered source features with
the edge spherical harmonics, segment-summed into destination nodes and
normalized by sqrt(avg num neighbors). The gather -> TP -> scatter runs
over statically padded, destination-sorted edge lists; dummy edges carry
zero SH/radial attributes and deposit into masked nodes.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from matten_tpu.data import keys as K
from matten_tpu.nn.common import (
    IrrepsDictT,
    check_required,
    irreps_dict,
    merge_irreps,
    normal_initializer,
)
from matten_tpu.nn.gate import ActivationInfo
from matten_tpu.nn.module import Module
from matten_tpu.nn.norm import IrrepsBatchNorm, IrrepsInstanceNorm
from matten_tpu.nn.radial import ScalarMLP
from matten_tpu.ops.irreps import Irreps
from matten_tpu.ops.scatter import scatter_sum
from matten_tpu.ops.tensor_product import (
    TensorProductPlan,
    fully_connected_tp_plan,
    uvu_tp_plan,
)


@functools.lru_cache(maxsize=None)
def _conv_plans(
    feats_in: Irreps, attrs: Irreps, edge_attrs: Irreps, conv_out: Irreps
) -> Tuple[TensorProductPlan, TensorProductPlan, TensorProductPlan, TensorProductPlan]:
    """(sc, lin1, uvu, lin2) plans for a PointConv layer (cached)."""
    sc = fully_connected_tp_plan(feats_in, attrs, conv_out)
    lin1 = fully_connected_tp_plan(feats_in, attrs, feats_in)
    uvu = uvu_tp_plan(feats_in, edge_attrs, conv_out)
    lin2 = fully_connected_tp_plan(uvu.irreps_out.simplify(), attrs, conv_out)
    return sc, lin1, uvu, lin2


class PointConv(Module):
    """TFN point convolution.

    `graph_axis`: name of a shard_map mesh axis over which the *edge list*
    is partitioned (node arrays replicated). Each shard aggregates messages
    from its local edges; the per-node partial convolutions are combined by
    a psum after the (linear) lin2 mixing — the edge-parallel
    strategy SURVEY.md §7.6 calls for (no reference counterpart; the
    reference's only parallelism is Lightning DDP).
    """

    irreps_in: IrrepsDictT
    conv_layer_irreps: Irreps
    fc_num_hidden_layers: int = 1
    fc_hidden_size: int = 8
    avg_num_neighbors: Optional[float] = None
    graph_axis: Optional[str] = None
    # "edge": edges sharded, nodes replicated, partial convs psum'd.
    # "node": nodes AND edges sharded (edges live with their dst owner);
    #         source features halo-gathered, aggregation local.
    graph_shard_mode: str = "edge"

    REQUIRED = (K.NODE_FEATURES, K.NODE_ATTRS, K.EDGE_ATTRS, K.EDGE_EMBEDDING)

    def _plans(self):
        d = irreps_dict(self.irreps_in)
        return _conv_plans(
            Irreps(d[K.NODE_FEATURES]),
            Irreps(d[K.NODE_ATTRS]),
            Irreps(d[K.EDGE_ATTRS]),
            Irreps(self.conv_layer_irreps),
        )

    @property
    def irreps_out(self) -> IrrepsDictT:
        check_required(self.irreps_in, self.REQUIRED, type(self).__name__)
        return merge_irreps(
            self.irreps_in, {K.NODE_FEATURES: Irreps(self.conv_layer_irreps)}
        )

    def __call__(self, data: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
        data = dict(data)
        sc_plan, lin1_plan, uvu_plan, lin2_plan = self._plans()

        feats = data[K.NODE_FEATURES]
        attrs = data[K.NODE_ATTRS]
        edge_attrs = data[K.EDGE_ATTRS]
        edge_emb = data[K.EDGE_EMBEDDING]
        src, dst = data[K.EDGE_INDEX]
        num_nodes = feats.shape[0]

        w_sc = self.param("w_sc", normal_initializer(), (sc_plan.weight_numel,))
        w_lin1 = self.param("w_lin1", normal_initializer(), (lin1_plan.weight_numel,))
        w_lin2 = self.param("w_lin2", normal_initializer(), (lin2_plan.weight_numel,))

        # node_attrs is the species one-hot (SpeciesEmbedding). Three
        # formulations of the species-conditioned FCTPs, chosen by species
        # count S; the S thresholds are unmeasured on the GPU. The
        # per-species weight-table gather (apply_onehot2) is opt-in through
        # MATTEN_ONEHOT_GATHER_MIN_S; S >= 16 contracts against the one-hot
        # with the plain einsum (S-fold FLOPs); S < 16 runs one
        # [B*d, u] @ [u, S*w] matmul per in1 entry (apply_scalar_matmul).
        import os

        gather_min_s = int(os.environ.get("MATTEN_ONEHOT_GATHER_MIN_S", "100000"))
        compat = (
            sc_plan.in2_is_onehot_compatible
            and lin1_plan.in2_is_onehot_compatible
            and lin2_plan.in2_is_onehot_compatible
        )
        if (
            compat
            and K.SPECIES_INDEX in data
            and attrs.shape[-1] >= gather_min_s
        ):
            idx = jnp.clip(data[K.SPECIES_INDEX], 0, attrs.shape[-1] - 1)
            mask = data.get(K.NODE_MASK)
            apply_sc = lambda x, w, p: p.apply_onehot2(x, idx, w, mask=mask)
        elif compat and attrs.shape[-1] >= 16:
            # plain einsum against the S-wide one-hot; mask keeps parity
            # with apply_onehot2's padded-node zeroing
            mask = data.get(K.NODE_MASK)

            def apply_sc(x, w, p):
                res = p.apply(x, attrs, w)
                if mask is not None:
                    res = res * mask[:, None].astype(res.dtype)
                return res

        elif compat:
            apply_sc = lambda x, w, p: p.apply_scalar_matmul(x, attrs, w)
        else:
            apply_sc = lambda x, w, p: p.apply(x, attrs, w)

        self_connection = apply_sc(feats, w_sc, sc_plan)

        feats = apply_sc(feats, w_lin1, lin1_plan)

        # radial MLP -> per-edge uvu weights
        hs = (
            [edge_emb.shape[-1]]
            + self.fc_num_hidden_layers * [self.fc_hidden_size]
            + [uvu_plan.weight_numel]
        )
        radial_mlp = ScalarMLP(hs=tuple(hs), act="silu", name="radial_mlp")
        edge_weights = radial_mlp(edge_emb)

        initializing = self.is_initializing()
        if (
            self.graph_axis is not None
            and self.graph_shard_mode == "node_ring"
            and not initializing
        ):
            # ring-overlapped halo exchange: node-feature chunks circulate
            # around the graph axis with ppermute while each shard
            # aggregates the edge group whose sources are in the chunk it
            # currently holds — the exchange of chunk k+1 overlaps the
            # aggregation of chunk k (async collectives), so the transfer
            # hides behind compute (the SURVEY §7.6 north-star pattern).
            sg = jax.lax.axis_size(self.graph_axis)
            me = jax.lax.axis_index(self.graph_axis)
            e_loc = src.shape[0]
            cap2 = e_loc // sg
            c = num_nodes  # nodes per shard
            src_g = src.reshape(sg, cap2)
            dst_g = dst.reshape(sg, cap2)
            sh_g = edge_attrs.reshape(sg, cap2, -1)
            w_g = edge_weights.reshape(sg, cap2, -1)
            perm = [(i, (i + 1) % sg) for i in range(sg)]
            chunk = feats
            agg = None
            for k in range(sg):
                g = (me - k) % sg
                take = lambda a: jax.lax.dynamic_index_in_dim(
                    a, g, axis=0, keepdims=False
                )
                nxt = (
                    jax.lax.ppermute(chunk, self.graph_axis, perm)
                    if k < sg - 1
                    else None
                )
                src_local = take(src_g) - g * c
                msg = uvu_plan.apply(chunk[src_local], take(sh_g), take(w_g))
                part = scatter_sum(msg, take(dst_g), num_nodes).astype(chunk.dtype)
                agg = part if agg is None else agg + part
                if nxt is not None:
                    chunk = nxt
        else:
            node_shard = (
                self.graph_axis is not None
                and self.graph_shard_mode == "node"
                and not initializing
            )
            if node_shard:
                # simple halo: gather every shard's (post-lin1) features;
                # src ids are global, aggregation is dst-local
                feats_src = jax.lax.all_gather(feats, self.graph_axis, tiled=True)
            else:
                feats_src = feats
            msg = uvu_plan.apply(feats_src[src], edge_attrs, edge_weights)
            agg = scatter_sum(msg, dst, num_nodes)

        if self.avg_num_neighbors is not None:
            agg = agg / np.sqrt(self.avg_num_neighbors)
        else:
            nn_cnt = jnp.maximum(data[K.NUM_NEIGH], 1.0)
            agg = agg / jnp.sqrt(nn_cnt)[:, None]

        conv_out = apply_sc(agg, w_lin2, lin2_plan)
        if (
            self.graph_axis is not None
            and self.graph_shard_mode == "edge"
            and not self.is_initializing()
        ):
            # edge-shard mode: combine per-shard partial convolutions
            # (linear in agg, so the psum rides after the cheap lin2
            # output). In node-shard mode the aggregation is already
            # complete locally — edges live with their dst owner. Skipped
            # at init time (outside the shard_map axis context).
            conv_out = jax.lax.psum(conv_out, self.graph_axis)

        data[K.NODE_FEATURES] = self_connection + conv_out
        return data


class PointConvWithActivation(Module):
    """conv -> gate activation -> (batch|instance|none) normalization."""

    irreps_in: IrrepsDictT
    conv_layer_irreps: Irreps
    fc_num_hidden_layers: int = 1
    fc_hidden_size: int = 8
    avg_num_neighbors: Optional[float] = None
    activation_type: str = "gate"
    activation_scalars: Optional[Tuple[Tuple[str, str], ...]] = None
    activation_gates: Optional[Tuple[Tuple[str, str], ...]] = None
    normalization: Optional[str] = None
    graph_axis: Optional[str] = None
    graph_shard_mode: str = "edge"

    def _act_info(self) -> ActivationInfo:
        d = irreps_dict(self.irreps_in)
        return ActivationInfo(
            Irreps(d[K.NODE_FEATURES]),
            Irreps(d[K.EDGE_ATTRS]),
            Irreps(self.conv_layer_irreps),
            activation_type=self.activation_type,
            activation_scalars=dict(self.activation_scalars)
            if self.activation_scalars
            else None,
            activation_gates=dict(self.activation_gates)
            if self.activation_gates
            else None,
        )

    @property
    def irreps_out(self) -> IrrepsDictT:
        return merge_irreps(
            self.irreps_in, {K.NODE_FEATURES: self._act_info().irreps_out}
        )

    def __call__(
        self, data: Dict[str, jnp.ndarray], use_running_average: bool = False
    ) -> Dict[str, jnp.ndarray]:
        info = self._act_info()
        data = PointConv(
            irreps_in=self.irreps_in,
            conv_layer_irreps=info.irreps_in,
            fc_num_hidden_layers=self.fc_num_hidden_layers,
            fc_hidden_size=self.fc_hidden_size,
            avg_num_neighbors=self.avg_num_neighbors,
            graph_axis=self.graph_axis,
            graph_shard_mode=self.graph_shard_mode,
            name="conv",
        )(data)
        x = info.make()(data[K.NODE_FEATURES])

        mask = data.get(K.NODE_MASK)
        norm_axis = (
            self.graph_axis
            if self.graph_axis is not None
            and self.graph_shard_mode in ("node", "node_ring")
            else None
        )
        if self.normalization == "batch":
            x = IrrepsBatchNorm(irreps=info.irreps_out, axis=norm_axis, name="norm")(
                x, mask=mask, use_running_average=use_running_average
            )
        elif self.normalization == "instance":
            num_graphs = data[K.CELL].reshape(-1, 3, 3).shape[0]
            x = IrrepsInstanceNorm(irreps=info.irreps_out, name="norm")(
                x, data[K.BATCH], num_graphs, mask=mask
            )
        elif self.normalization not in (None, "none"):
            raise ValueError(f"unknown normalization {self.normalization!r}")

        if mask is not None:
            x = x * mask[:, None].astype(x.dtype)
        data = dict(data)
        data[K.NODE_FEATURES] = x
        return data
