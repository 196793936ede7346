"""NaN/Inf anomaly detection for the data dict.

Reference: detect_nan_and_inf / DetectAnomaly (utils.py:68-107,
nn/utils.py:370-394) — interleaved into the model between layers at DEBUG
log level (model_factory/utils.py:85-87). The jit-compatible version uses
jax.debug.check / checkify-style error funneling via debug callbacks;
`jax.config.jax_debug_nans` remains the heavyweight fallback.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from matten_tpu.nn.module import Module

__all__ = ["check_finite", "DetectAnomaly", "enable_nan_debugging"]


def check_finite(data: Dict[str, jnp.ndarray], where: str = "") -> None:
    """Host-callback finite check of every float field (works under jit)."""

    def _report(name, bad_count):
        if int(bad_count) > 0:
            raise FloatingPointError(
                f"non-finite values in field {name!r} after {where}"
            )

    for name, x in data.items():
        if jnp.issubdtype(x.dtype, jnp.floating):
            bad = jnp.size(x) - jnp.isfinite(x).sum()
            jax.debug.callback(_report, name, bad, ordered=False)


class DetectAnomaly(Module):
    """Layer wrapper: forwards `data` unchanged, checking every field."""

    label: str = ""

    def __call__(self, data: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
        check_finite(data, self.label)
        return data


def enable_nan_debugging() -> None:
    """Global NaN debugging (recompiles with checks; slow — debug only)."""
    jax.config.update("jax_debug_nans", True)
