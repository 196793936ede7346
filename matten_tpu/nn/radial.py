"""Radial basis functions and the variance-preserving scalar MLP.

Replaces e3nn.math.soft_one_hot_linspace (bessel basis; reference
nn/embedding.py:189) and e3nn.nn.FullyConnectedNet (reference
nn/utils.py:251): weights ~ N(0,1), forward scaled by 1/sqrt(fan_in), and
activations rescaled to unit second moment under N(0,1) input
("normalize2mom") — the init convention the reference's training dynamics
(Adam, lr=0.01) assume.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from matten_tpu.nn.common import normal_initializer
from matten_tpu.nn.module import Module

__all__ = [
    "bessel_basis",
    "soft_one_hot_linspace",
    "normalize2mom",
    "shifted_softplus",
    "ScalarMLP",
    "ACTIVATIONS",
]


def shifted_softplus(x):
    return jax.nn.softplus(x) - float(np.log(2.0))


_RAW_ACTIVATIONS = {
    "ssp": shifted_softplus,
    "silu": jax.nn.silu,
    "sigmoid": jax.nn.sigmoid,
    "tanh": jnp.tanh,
    "abs": jnp.abs,
    "identity": lambda x: x,
}


_NP_ACTIVATIONS = {
    "ssp": lambda x: np.logaddexp(x, 0.0) - np.log(2.0),
    "silu": lambda x: x / (1.0 + np.exp(-x)),
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "tanh": np.tanh,
    "abs": np.abs,
    "identity": lambda x: x,
}


@functools.lru_cache(maxsize=None)
def _second_moment(name: str) -> float:
    """E_{z~N(0,1)}[act(z)^2] via Gauss-Hermite quadrature (float64)."""
    nodes, weights = np.polynomial.hermite_e.hermegauss(128)
    w = weights / np.sqrt(2 * np.pi)
    vals = _NP_ACTIVATIONS[name](nodes.astype(np.float64))
    return float((w * vals**2).sum())


def normalize2mom(name: str) -> Callable:
    """Activation scaled so its output has unit second moment under N(0,1)."""
    fn = _RAW_ACTIVATIONS[name]
    c = 1.0 / np.sqrt(_second_moment(name))
    if abs(c - 1.0) < 1e-4:
        return fn
    return lambda x: fn(x) * c


ACTIVATIONS = {
    # parity-safe activation tables (reference nn/utils.py:14-26)
    1: {"ssp": "ssp", "silu": "silu", "sigmoid": "sigmoid"},  # even
    -1: {"abs": "abs", "tanh": "tanh"},  # odd
}


def bessel_basis(
    x: jnp.ndarray, num_basis: int, start: float = 0.0, end: float = 5.0,
    cutoff: bool = True,
) -> jnp.ndarray:
    """sqrt(2/c) * sin(n pi x / c) / x on (start, end), zero outside.

    Matches e3nn soft_one_hot_linspace(basis="bessel", cutoff=True) used by
    the reference's EdgeLengthEmbedding (nn/embedding.py:185-199).
    """
    c = end - start
    xs = x[..., None] - start
    n = jnp.arange(1, num_basis + 1, dtype=x.dtype)
    safe = jnp.where(xs > 1e-10, xs, 1.0)
    out = np.sqrt(2.0 / c) * jnp.sin(n * np.pi * safe / c) / safe
    window = ((xs > 0) & (xs < c)).astype(x.dtype) if cutoff else jnp.ones_like(xs)
    return out * window


def soft_one_hot_linspace(
    x: jnp.ndarray, start: float, end: float, number: int,
    basis: str = "bessel", cutoff: bool = True,
) -> jnp.ndarray:
    if basis == "bessel":
        return bessel_basis(x, number, start, end, cutoff)
    if basis == "gaussian":
        # evenly spaced gaussians, normalized to ~unit second moment
        if cutoff:
            centers = np.linspace(start, end, number + 2)[1:-1]
        else:
            centers = np.linspace(start, end, number)
        step = centers[1] - centers[0] if number > 1 else (end - start)
        diff = (x[..., None] - centers.astype(np.float64)) / step
        return jnp.exp(-diff**2) * 1.12
    raise ValueError(f"unsupported basis {basis!r}")


class ScalarMLP(Module):
    """Fully connected net on invariant scalars, e3nn init convention.

    hs = [in, hidden, ..., out]; hidden layers use `act` (normalize2mom'd),
    the output layer is linear. All layers: h @ W / sqrt(fan_in), W~N(0,1).
    """

    hs: Sequence[int]
    act: str = "ssp"

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        act = normalize2mom(self.act)
        n = len(self.hs) - 1
        for i in range(n):
            d_in, d_out = self.hs[i], self.hs[i + 1]
            w = self.param(f"w{i}", normal_initializer(1.0), (d_in, d_out))
            x = x @ w.astype(x.dtype) / np.sqrt(d_in)
            if i < n - 1:
                x = act(x)
        return x
