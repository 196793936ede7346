"""Node-wise linear / pooling / selection modules.

Reference: NodewiseLinear, NodewiseReduce, NodewiseSelect
(nn/nodewise.py:89,120,18).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax.numpy as jnp

from matten_tpu.data import keys as K
from matten_tpu.nn.common import IrrepsDictT, irreps_dict, merge_irreps, normal_initializer
from matten_tpu.nn.module import Module
from matten_tpu.ops.irreps import Irreps
from matten_tpu.ops.scatter import scatter_max, scatter_min, scatter_sum
from matten_tpu.ops.tensor_product import LinearPlan


class NodewiseLinear(Module):
    """Equivariant linear map on a node field (e3nn o3.Linear, no bias)."""

    irreps_in: IrrepsDictT
    irreps_out_field: Irreps
    field: str = K.NODE_FEATURES
    out_field: Optional[str] = None

    @property
    def _out_field(self) -> str:
        return self.out_field if self.out_field is not None else self.field

    @property
    def irreps_out(self) -> IrrepsDictT:
        return merge_irreps(
            self.irreps_in, {self._out_field: Irreps(self.irreps_out_field)}
        )

    def __call__(self, data: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
        data = dict(data)
        plan = LinearPlan(
            Irreps(irreps_dict(self.irreps_in)[self.field]),
            Irreps(self.irreps_out_field),
        )
        w = self.param("w", normal_initializer(), (plan.weight_numel,))
        data[self._out_field] = plan.apply(data[self.field], w)
        return data


class NodewiseReduce(Module):
    """Masked scatter-reduce of a node field into per-graph features.

    Supports sum/mean/min/max like the reference (nn/nodewise.py:120-148,
    which delegates to torch_scatter). min/max replace masked (dummy) node
    rows with +/-inf sentinels before the segment reduction and return 0 for
    graphs with no valid nodes (only possible for all-dummy padding graphs).
    """

    irreps_in: IrrepsDictT
    field: str = K.NODE_FEATURES
    out_field: Optional[str] = None
    reduce: str = "sum"  # "sum" | "mean" | "min" | "max"
    # shard_map axis over which nodes are sharded: per-graph partial sums
    # are combined across it (node-sharded graph parallelism)
    axis: Optional[str] = None

    @property
    def _out_field(self) -> str:
        return (
            self.out_field if self.out_field is not None else f"{self.reduce}_{self.field}"
        )

    @property
    def irreps_out(self) -> IrrepsDictT:
        return merge_irreps(
            self.irreps_in,
            {self._out_field: irreps_dict(self.irreps_in)[self.field]},
        )

    def __call__(self, data: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
        import jax

        data = dict(data)
        x = data[self.field]
        batch = data[K.BATCH]
        num_graphs = data[K.CELL].reshape(-1, 3, 3).shape[0]
        mask = data.get(K.NODE_MASK)
        w = (
            mask.astype(x.dtype)
            if mask is not None
            else jnp.ones(x.shape[0], dtype=x.dtype)
        )
        if self.reduce in ("sum", "mean"):
            num = scatter_sum(x * w[:, None], batch, num_graphs)
            den = scatter_sum(w, batch, num_graphs)
            if self.axis is not None and not self.is_initializing():
                num = jax.lax.psum(num, self.axis)
                den = jax.lax.psum(den, self.axis)
            out = num if self.reduce == "sum" else num / jnp.maximum(den, 1.0)[:, None]
        elif self.reduce in ("min", "max"):
            sentinel = jnp.inf if self.reduce == "min" else -jnp.inf
            xm = jnp.where(w[:, None] > 0, x, jnp.asarray(sentinel, x.dtype))
            red = scatter_min if self.reduce == "min" else scatter_max
            out = red(xm, batch, num_graphs)
            if self.axis is not None and not self.is_initializing():
                out = (
                    jax.lax.pmin(out, self.axis)
                    if self.reduce == "min"
                    else jax.lax.pmax(out, self.axis)
                )
            # graphs with no valid node anywhere (all-dummy padding) -> 0
            out = jnp.where(jnp.isfinite(out), out, jnp.zeros_like(out))
        else:
            raise ValueError(f"unsupported reduce {self.reduce!r}")
        data[self._out_field] = out
        return data


class NodewiseSelect(Module):
    """Mask a node field by a boolean per-node selector (e.g. atom_selector).

    Static shapes: instead of gathering a dynamic-size subset (reference
    nn/nodewise.py:18-86), the field is zero-masked at static shape; loss /
    metric reductions use the same mask.
    """

    irreps_in: IrrepsDictT
    field: str = K.NODE_FEATURES
    out_field: Optional[str] = None
    mask_field: str = K.ATOM_SELECTOR

    @property
    def _out_field(self) -> str:
        return self.out_field if self.out_field is not None else f"selected_{self.field}"

    @property
    def irreps_out(self) -> IrrepsDictT:
        return merge_irreps(
            self.irreps_in,
            {self._out_field: irreps_dict(self.irreps_in)[self.field]},
        )

    def __call__(self, data: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
        data = dict(data)
        x = data[self.field]
        sel = data[self.mask_field]
        data[self._out_field] = x * sel[:, None].astype(x.dtype)
        return data
