"""Shared infrastructure for irreps-typed modules.

The reference attaches declared input/output irreps to every module and
validates compatibility when stacking (ModuleIrreps, data/irreps.py:17-209;
Sequential, nn/sequential.py:9). Here irreps metadata is *static module
state* — module dataclass fields — threaded at model-construction time,
so every CG path table is known before tracing (SURVEY.md §3.4).

Because module fields should be hashable, irreps dicts are stored as
tuples of (field, Irreps) pairs; `freeze_irreps`/`irreps_dict` convert.
A value of None marks a non-irreps (invariant index/mask) field.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np

from matten_tpu.ops.irreps import Irreps

IrrepsDictT = Tuple[Tuple[str, Optional[Irreps]], ...]


def freeze_irreps(mapping: Union[Mapping, IrrepsDictT, None]) -> IrrepsDictT:
    """Normalize a {field: irreps-like} mapping into a hashable tuple."""
    if mapping is None:
        return ()
    if isinstance(mapping, tuple):
        items = mapping
    else:
        items = tuple(mapping.items())
    out = []
    for k, v in items:
        out.append((k, None if v is None else Irreps(v)))
    return tuple(out)


def irreps_dict(frozen: IrrepsDictT) -> Dict[str, Optional[Irreps]]:
    return dict(frozen)


def merge_irreps(
    irreps_in: IrrepsDictT, updates: Mapping[str, Optional[Irreps]]
) -> IrrepsDictT:
    d = irreps_dict(freeze_irreps(irreps_in))
    for k, v in updates.items():
        d[k] = None if v is None else Irreps(v)
    return freeze_irreps(d)


def check_required(irreps_in: IrrepsDictT, required: Tuple[str, ...], who: str):
    d = irreps_dict(irreps_in)
    for k in required:
        if k not in d:
            raise ValueError(f"{who}: required input field {k!r} missing from irreps_in")


def normal_initializer(std: float = 1.0):
    """N(0, std) initializer — the e3nn weight convention (variance carried
    by forward-pass scaling, not by init)."""
    import jax

    def init(key, shape, dtype=np.float32):
        return std * jax.random.normal(key, shape, dtype)

    return init
