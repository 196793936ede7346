"""Irreps-aware batch / instance normalization, mask-aware for padded graphs.

Replaces e3nn.nn.BatchNorm (reference N6; used via NormalizationLayer,
nn/utils.py:397-446) with e3nn semantics: per-irrep-entry statistics,
scalars get mean subtraction, all entries get second-moment ("component")
normalization, running statistics with momentum, affine weight (+ bias for
scalars). Statistics exclude padded nodes via the node mask — the reference
has no padding so this is the static-shape correctness addition SURVEY.md §7
calls out (hard part 3).

The reference's custom InstanceNorm has a known train/eval bug
(nn/utils.py:440-441); the instance norm here is implemented cleanly
(per-graph statistics always, no running stats).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from matten_tpu.nn.module import Module
from matten_tpu.ops.irreps import Irreps
from matten_tpu.ops.scatter import scatter_mean

__all__ = ["IrrepsBatchNorm", "IrrepsInstanceNorm"]


@functools.lru_cache(maxsize=None)
def _bn_meta(irreps: Irreps):
    """Static component<->feature maps for vectorized irreps batch norm.

    Feature channels are (entry, mul-channel) pairs in entry order —
    exactly the order the per-entry loop produced, so running-stat and
    affine parameter layouts are unchanged. Returns:
      comp2feat [D]  — feature channel of each component (u-major within
                       an entry: channel index repeats d times)
      msq_mat [D, F] — one-hot/d matrix: (x^2) @ msq_mat = per-channel
                       mean square over the entry's d components
      n_scalars      — leading scalar components (l=0 entries come first
                       in the sorted activation output irreps)
    """
    comp2feat, scal_comp, feat_base, comp_base = [], [], 0, 0
    for mul, ir in irreps:
        comp2feat.append(np.repeat(feat_base + np.arange(mul), ir.dim))
        if ir.l == 0:
            scal_comp.append(comp_base + np.arange(mul))
        feat_base += mul
        comp_base += mul * ir.dim
    comp2feat = np.concatenate(comp2feat).astype(np.int32)
    scal_comp = (
        np.concatenate(scal_comp).astype(np.int32)
        if scal_comp
        else np.zeros(0, np.int32)
    )
    D, F = comp2feat.shape[0], feat_base
    msq_mat = np.zeros((D, F), dtype=np.float32)
    inv_d = np.zeros(F, dtype=np.float64)
    np.add.at(inv_d, comp2feat, 1.0)
    msq_mat[np.arange(D), comp2feat] = (1.0 / inv_d)[comp2feat]
    return comp2feat, msq_mat, scal_comp


class IrrepsBatchNorm(Module):
    irreps: Irreps
    eps: float = 1e-5
    momentum: float = 0.1
    affine: bool = True
    # shard_map axis over which nodes are sharded: statistics are reduced
    # across it (cross-replica batch-norm sync; not needed for edge-shard
    # or pure data parallelism where per-shard stats mirror torch DDP)
    axis: Optional[str] = None

    def _reduce(self, num, den):
        if self.axis is not None and not self.is_initializing():
            num = jax.lax.psum(num, self.axis)
            den = jax.lax.psum(den, self.axis)
        return num / jnp.maximum(den, 1.0)

    def __call__(
        self,
        x: jnp.ndarray,
        mask: Optional[jnp.ndarray] = None,
        use_running_average: bool = False,
    ) -> jnp.ndarray:
        irreps = Irreps(self.irreps)
        num_scalars = sum(mul for mul, ir in irreps if ir.l == 0)
        num_features = irreps.num_irreps

        running_mean = self.variable(
            "batch_stats", "running_mean", lambda: jnp.zeros(num_scalars)
        )
        running_var = self.variable(
            "batch_stats", "running_var", lambda: jnp.ones(num_features)
        )
        if self.affine:
            weight = self.param("weight", jax.nn.initializers.ones, (num_features,))
            bias = self.param("bias", jax.nn.initializers.zeros, (num_scalars,))

        if mask is not None:
            m = mask.astype(x.dtype)
        else:
            m = jnp.ones(x.shape[0], dtype=x.dtype)
        count = m.sum()

        # vectorized over ALL irrep entries at once via static
        # component<->feature maps (the per-entry slice/reshape loop was
        # ~90 tiny ops per layer — a measurable slice of the r4 step's
        # small-op tail). Statistics/affine layouts match the loop exactly.
        comp2feat, msq_mat, scal_comp = _bn_meta(irreps)
        c2f = jnp.asarray(comp2feat)
        xm = x * m[:, None]

        # scalar means (scalar components == scalar feature channels)
        if use_running_average:
            fmean = running_mean.value
        else:
            fmean = self._reduce(xm[:, scal_comp].sum(0), count)
        mean_comp = (
            jnp.zeros(x.shape[-1], x.dtype)
            .at[scal_comp]
            .set(fmean.astype(x.dtype))
        )
        xc = x - mean_comp

        if use_running_average:
            fnorm = running_var.value
        else:
            # component normalization: mean square per channel over (real)
            # nodes and m-components — one [D, F] matmul
            fnorm = self._reduce(
                ((xc * xc) * m[:, None]).sum(0) @ jnp.asarray(msq_mat), count
            )
        factor = 1.0 / jnp.sqrt(fnorm.astype(x.dtype) + self.eps)
        if self.affine:
            factor = factor * weight.astype(x.dtype)
        out = xc * factor[c2f]
        if self.affine and scal_comp.size:
            out = out.at[:, scal_comp].add(bias.astype(x.dtype))

        if not use_running_average and not self.is_initializing():
            if scal_comp.size:
                running_mean.value = (
                    (1 - self.momentum) * running_mean.value + self.momentum * fmean
                )
            running_var.value = (
                (1 - self.momentum) * running_var.value + self.momentum * fnorm
            )
        return out


class IrrepsInstanceNorm(Module):
    """Per-graph irreps norm: statistics over each graph's (real) nodes."""

    irreps: Irreps
    eps: float = 1e-5
    affine: bool = True
    reduce: str = "mean"  # reduction over nodes for the norm statistic

    def __call__(
        self,
        x: jnp.ndarray,
        batch: jnp.ndarray,
        num_graphs: int,
        mask: Optional[jnp.ndarray] = None,
        use_running_average: bool = False,  # unused; instance stats always
    ) -> jnp.ndarray:
        irreps = Irreps(self.irreps)
        num_scalars = sum(mul for mul, ir in irreps if ir.l == 0)
        num_features = irreps.num_irreps
        if self.affine:
            weight = self.param("weight", jax.nn.initializers.ones, (num_features,))
            bias = self.param("bias", jax.nn.initializers.zeros, (num_scalars,))

        out = []
        off = 0
        i_mean = 0
        i_feat = 0
        for mul, ir in irreps:
            d = ir.dim
            blk = x[..., off : off + mul * d].reshape(x.shape[:-1] + (mul, d))
            off += mul * d
            if ir.l == 0:
                gmean = scatter_mean(blk[..., 0], batch, num_graphs, weights=mask)
                blk = blk - gmean[batch][..., None]
            fnorm = scatter_mean((blk**2).mean(-1), batch, num_graphs, weights=mask)
            factor = 1.0 / jnp.sqrt(fnorm[batch] + self.eps)
            if self.affine:
                factor = factor * weight[i_feat : i_feat + mul].astype(x.dtype)
            blk = blk * factor[..., None]
            if ir.l == 0 and self.affine:
                blk = blk + bias[i_mean : i_mean + mul].astype(x.dtype)[:, None]
                i_mean += mul
            i_feat += mul
            out.append(blk.reshape(blk.shape[:-2] + (mul * d,)))
        return jnp.concatenate(out, axis=-1)
