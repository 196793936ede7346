"""Equivariant gate / norm nonlinearities.

Replaces e3nn.nn.Gate and e3nn.nn.NormActivation and re-derives the
reference's ActivationLayer irreps logic (nn/utils.py:29-167): given the
tensor-product inputs and the *intended* output irreps, determine which
scalars/gates/gated irreps are actually producible (tp_path_exists
filtering), choose the gate parity (0e preferred, 0o fallback), and expose
 - irreps_in  = scalars + gates + gated   (what the conv must output)
 - irreps_out = scalars + gated           (post-activation features)
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from matten_tpu.nn.module import Module
from matten_tpu.nn.radial import normalize2mom
from matten_tpu.ops.irreps import Irrep, Irreps, tp_path_exists

__all__ = ["ActivationInfo", "Gate", "NormActivation"]


class ActivationInfo:
    """Static plan for the activation following a TFN convolution."""

    def __init__(
        self,
        tp_irreps_in1: Irreps,
        tp_irreps_in2: Irreps,
        tp_irreps_out: Irreps,
        activation_type: str = "gate",
        activation_scalars: Dict[str, str] = None,
        activation_gates: Dict[str, str] = None,
    ):
        # defaults follow the reference PointConvWithActivation signature
        # (nn/conv.py:155-156)
        activation_scalars = activation_scalars or {"e": "silu", "o": "tanh"}
        activation_gates = activation_gates or {"e": "sigmoid", "o": "tanh"}
        self.activation_type = activation_type

        tp_irreps_out = Irreps(tp_irreps_out).sort()[0].simplify()
        self.irreps_scalars = Irreps(
            [
                (mul, ir)
                for mul, ir in tp_irreps_out
                if ir.l == 0 and tp_path_exists(tp_irreps_in1, tp_irreps_in2, ir)
            ]
        )
        self.irreps_gated = Irreps(
            [
                (mul, ir)
                for mul, ir in tp_irreps_out
                if ir.l > 0 and tp_path_exists(tp_irreps_in1, tp_irreps_in2, ir)
            ]
        )
        if activation_type == "gate":
            if self.irreps_gated.dim > 0:
                if tp_path_exists(tp_irreps_in1, tp_irreps_in2, "0e"):
                    gate_ir = Irrep(0, 1)
                elif tp_path_exists(tp_irreps_in1, tp_irreps_in2, "0o"):
                    gate_ir = Irrep(0, -1)
                else:
                    raise ValueError(
                        f"{tp_irreps_in1} x {tp_irreps_in2} cannot produce gate "
                        f"scalars for {self.irreps_gated}"
                    )
                self.irreps_gates = Irreps(
                    [(mul, gate_ir) for mul, _ in self.irreps_gated]
                ).simplify()
            else:
                self.irreps_gates = Irreps()
            self.irreps_in = (
                self.irreps_scalars + self.irreps_gates + self.irreps_gated
            )
            gate_p = self.irreps_gates[0].ir.p if self.irreps_gates else 1
            self.irreps_out = self.irreps_scalars + Irreps(
                [(mul, Irrep(ir.l, ir.p * gate_p)) for mul, ir in self.irreps_gated]
            )
        elif activation_type == "norm":
            self.irreps_in = (self.irreps_scalars + self.irreps_gated).simplify()
            self.irreps_gates = Irreps()
            self.irreps_out = self.irreps_in
        else:
            raise ValueError(f"unsupported activation_type {activation_type!r}")

        def _act_name(table: Dict[str, str], p: int) -> str:
            return table["e" if p == 1 else "o"]

        self.act_scalars: Tuple[Tuple[int, str], ...] = tuple(
            (mul, _act_name(activation_scalars, ir.p)) for mul, ir in self.irreps_scalars
        )
        self.act_gates: Tuple[Tuple[int, str], ...] = tuple(
            (mul, _act_name(activation_gates, ir.p)) for mul, ir in self.irreps_gates
        )
        self.act_scalar_even = _act_name(activation_scalars, 1)

    def make(self) -> Module:
        if self.activation_type == "gate":
            return Gate(info=self)
        return NormActivation(irreps=self.irreps_in, act=self.act_scalar_even)


class Gate(Module):
    """[scalars | gates | gated] -> [act(scalars) | act(gates) * gated]."""

    info: ActivationInfo

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        info = self.info
        n_s = info.irreps_scalars.dim
        n_g = info.irreps_gates.dim
        scalars = x[..., :n_s]
        gates = x[..., n_s : n_s + n_g]
        gated = x[..., n_s + n_g :]

        out_scalars = []
        i = 0
        for mul, name in info.act_scalars:
            out_scalars.append(normalize2mom(name)(scalars[..., i : i + mul]))
            i += mul
        acted_gates = []
        i = 0
        for mul, name in info.act_gates:
            acted_gates.append(normalize2mom(name)(gates[..., i : i + mul]))
            i += mul
        if acted_gates:
            g = jnp.concatenate(acted_gates, axis=-1)  # [..., total_gated_mul]
            # one static-index expansion [gate channel -> component] and a
            # single elementwise multiply instead of a per-entry
            # slice/reshape loop (fewer small ops)
            idx, base = [], 0
            for mul, ir in info.irreps_gated:
                idx.append(np.repeat(base + np.arange(mul), ir.dim))
                base += mul
            idx = np.concatenate(idx).astype(np.int32)
            out_gated = [gated * g[..., idx]]
        else:
            out_gated = [gated] if gated.shape[-1] else []
        return jnp.concatenate(out_scalars + out_gated, axis=-1)


class NormActivation(Module):
    """x_ch -> x_ch * act(||x_ch||) / ||x_ch|| per irrep channel.

    Reference: e3nn NormActivation via ActivationLayer(activation_type=
    "norm") (nn/utils.py:142-151); normalize=True, epsilon=1e-8, no bias.
    """

    irreps: Irreps
    act: str = "silu"
    epsilon: float = 1e-8

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        fn = normalize2mom(self.act)
        out = []
        off = 0
        for mul, ir in Irreps(self.irreps):
            blk = x[..., off : off + mul * ir.dim]
            off += mul * ir.dim
            if ir.l == 0:
                out.append(fn(blk))
                continue
            blk = blk.reshape(blk.shape[:-1] + (mul, ir.dim))
            n2 = (blk**2).sum(axis=-1, keepdims=True)
            n = jnp.sqrt(n2 + self.epsilon**2)
            blk = blk * (fn(n) / n)
            out.append(blk.reshape(blk.shape[:-2] + (mul * ir.dim,)))
        return jnp.concatenate(out, axis=-1)
