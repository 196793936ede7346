"""Segment (scatter) reductions with static segment counts.

Replacement for torch_scatter (reference N1; used for message aggregation
nn/conv.py:114, graph pooling nn/nodewise.py:144, norms
nn/utils.py:611,633): jax segment ops, which XLA lowers to sorted-scatter;
edges are pre-sorted by destination at batching time so the access pattern
is segment-local.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["scatter_sum", "scatter_mean", "scatter_max", "scatter_min"]


def scatter_sum(src: jnp.ndarray, index: jnp.ndarray, dim_size: int) -> jnp.ndarray:
    return jax.ops.segment_sum(src, index, num_segments=dim_size)


def scatter_mean(
    src: jnp.ndarray,
    index: jnp.ndarray,
    dim_size: int,
    weights: jnp.ndarray = None,
) -> jnp.ndarray:
    """Masked segment mean: optional per-element weights (e.g. a validity
    mask) are applied to both numerator and denominator."""
    if weights is not None:
        w = weights.astype(src.dtype)
        num = jax.ops.segment_sum(src * w.reshape(w.shape + (1,) * (src.ndim - 1)), index, num_segments=dim_size)
        den = jax.ops.segment_sum(w, index, num_segments=dim_size)
    else:
        num = jax.ops.segment_sum(src, index, num_segments=dim_size)
        den = jax.ops.segment_sum(jnp.ones(src.shape[0], dtype=src.dtype), index, num_segments=dim_size)
    den = jnp.maximum(den, 1.0)
    return num / den.reshape(den.shape + (1,) * (src.ndim - 1))


def scatter_max(src: jnp.ndarray, index: jnp.ndarray, dim_size: int) -> jnp.ndarray:
    return jax.ops.segment_max(src, index, num_segments=dim_size)


def scatter_min(src: jnp.ndarray, index: jnp.ndarray, dim_size: int) -> jnp.ndarray:
    return jax.ops.segment_min(src, index, num_segments=dim_size)
