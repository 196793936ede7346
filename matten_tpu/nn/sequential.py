"""Irreps-checked sequential container.

Reference: matten Sequential (nn/sequential.py:9-48) — validates that each
module's declared outputs cover the next module's required inputs at build
time (static irreps-shape inference, SURVEY.md §3.4).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import jax.numpy as jnp

from matten_tpu.nn.common import irreps_dict
from matten_tpu.nn.module import Module


def validate_chain(modules: Sequence[Module]) -> None:
    """Check irreps compatibility of consecutive dict-passing modules."""
    for a, b in zip(modules[:-1], modules[1:]):
        if not hasattr(a, "irreps_out") or not hasattr(b, "irreps_in"):
            continue
        out_d = irreps_dict(a.irreps_out)
        in_d = irreps_dict(b.irreps_in)
        for key, ir in in_d.items():
            if key not in out_d:
                raise ValueError(
                    f"{type(b).__name__} requires field {key!r} not produced by "
                    f"{type(a).__name__}"
                )
            if ir is not None and out_d[key] is not None:
                if tuple(out_d[key].simplify()) != tuple(ir.simplify()):
                    raise ValueError(
                        f"irreps mismatch on {key!r}: {type(a).__name__} gives "
                        f"{out_d[key]}, {type(b).__name__} expects {ir}"
                    )


class Sequential(Module):
    layers: Tuple[Module, ...]

    @property
    def irreps_in(self):
        return self.layers[0].irreps_in

    @property
    def irreps_out(self):
        return self.layers[-1].irreps_out

    def __call__(self, data: Dict[str, jnp.ndarray], **kwargs) -> Dict[str, jnp.ndarray]:
        for layer in self.layers:
            # thread optional flags (e.g. use_running_average) only to
            # modules that accept them
            if isinstance(layer, _ACCEPTS_TRAIN_FLAG):
                data = layer(data, **kwargs)
            else:
                data = layer(data)
        return data

from matten_tpu.nn.conv import PointConvWithActivation  # noqa: E402

_ACCEPTS_TRAIN_FLAG = (PointConvWithActivation,)
