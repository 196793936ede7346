"""Clebsch-Gordan tensor products as static plans + jnp contractions.

Re-derivation of the e3nn TensorProduct machinery the reference depends on
(e3nn 0.5.1 `o3.TensorProduct` / `o3.FullyConnectedTensorProduct` /
`o3.Linear`; used at reference nn/utils.py:230, nn/conv.py:59-84,
nn/nodewise.py:111). Instead of torchscript codegen, a `TensorProductPlan`
is a *static* description (instructions + per-path CG tables + normalization
constants) built once at model-construction time; its `apply` is a chain of
einsums that XLA fuses and maps onto matrix units.

Normalization follows the e3nn convention the reference's training dynamics
assume: `irrep_normalization="component"`, `path_normalization="element"`,
weights drawn from N(0,1) and the variance correction applied in the
forward pass (path_weight = sqrt(ir_out.dim / fan_in)).
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from matten_tpu.ops.irreps import Irrep, Irreps
from matten_tpu.ops.wigner import wigner_3j

__all__ = [
    "Instruction",
    "TensorProductPlan",
    "fully_connected_tp_plan",
    "uvu_tp_plan",
    "LinearPlan",
]


class Instruction(NamedTuple):
    i_in1: int
    i_in2: int
    i_out: int
    mode: str  # "uvw" | "uvu"
    has_weight: bool


class TensorProductPlan:
    """Static tensor-product plan: irreps metadata, instructions, constants.

    Hashable/immutable after construction; safe to close over in jitted fns.
    """

    def __init__(
        self,
        irreps_in1: Irreps,
        irreps_in2: Irreps,
        irreps_out: Irreps,
        instructions: Sequence[Instruction],
        irrep_normalization: str = "component",
        path_normalization: str = "element",
    ):
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        self.irreps_out = Irreps(irreps_out)
        self.instructions = tuple(Instruction(*i) for i in instructions)

        def num_elements(ins: Instruction) -> int:
            if ins.mode == "uvw":
                return self.irreps_in1[ins.i_in1].mul * self.irreps_in2[ins.i_in2].mul
            if ins.mode == "uvu":
                return self.irreps_in2[ins.i_in2].mul
            raise ValueError(f"unsupported mode {ins.mode}")

        # variance-preserving path weights
        self.path_weights: List[float] = []
        for ins in self.instructions:
            ir_out = self.irreps_out[ins.i_out].ir
            if irrep_normalization == "component":
                num = ir_out.dim
            elif irrep_normalization == "norm":
                num = (
                    self.irreps_in1[ins.i_in1].ir.dim
                    * self.irreps_in2[ins.i_in2].ir.dim
                )
            elif irrep_normalization == "none":
                num = 1
            else:
                raise ValueError(irrep_normalization)
            if path_normalization == "element":
                den = sum(
                    num_elements(j)
                    for j in self.instructions
                    if j.i_out == ins.i_out
                )
            elif path_normalization == "path":
                den = num_elements(ins) * sum(
                    1 for j in self.instructions if j.i_out == ins.i_out
                )
            elif path_normalization == "none":
                den = 1
            else:
                raise ValueError(path_normalization)
            self.path_weights.append(float(np.sqrt(num / max(den, 1))))

        # weight bookkeeping
        self.weight_shapes: List[Tuple[int, ...]] = []
        for ins in self.instructions:
            mul1 = self.irreps_in1[ins.i_in1].mul
            mul2 = self.irreps_in2[ins.i_in2].mul
            mul_out = self.irreps_out[ins.i_out].mul
            if not ins.has_weight:
                self.weight_shapes.append(())
            elif ins.mode == "uvw":
                self.weight_shapes.append((mul1, mul2, mul_out))
            elif ins.mode == "uvu":
                assert mul_out == mul1, "uvu requires mul_out == mul_in1"
                self.weight_shapes.append((mul1, mul2))
        self.weight_numel = int(
            sum(int(np.prod(s)) for s in self.weight_shapes if s)
        )

        self._in1_slices = self.irreps_in1.slices()
        self._in2_slices = self.irreps_in2.slices()
        self._out_slices = self.irreps_out.slices()

    # ------------------------------------------------------------------
    def split_weights(self, w: jnp.ndarray) -> List[Optional[jnp.ndarray]]:
        """Split a flat [..., weight_numel] array into per-instruction blocks."""
        out: List[Optional[jnp.ndarray]] = []
        i = 0
        for shape in self.weight_shapes:
            if not shape:
                out.append(None)
                continue
            n = int(np.prod(shape))
            out.append(w[..., i : i + n].reshape(w.shape[:-1] + shape))
            i += n
        return out

    def apply(
        self,
        x1: jnp.ndarray,
        x2: jnp.ndarray,
        weights: Optional[jnp.ndarray] = None,
    ) -> jnp.ndarray:
        """Compute the tensor product.

        Args:
            x1: [..., irreps_in1.dim]
            x2: [..., irreps_in2.dim]
            weights: flat weights. Either [weight_numel] (shared, e.g. an
                internal parameter) or [..., weight_numel] (per-element
                external weights, e.g. from a radial MLP) or None when the
                plan has no weighted instructions.

        Returns:
            [..., irreps_out.dim]
        """
        dtype = x1.dtype
        if self.weight_numel > 0:
            assert weights is not None, "plan has weights but none provided"
            wsplit = self.split_weights(weights)
        else:
            wsplit = [None] * len(self.instructions)

        chunks = [None] * len(self.irreps_out)
        for ins, pw, w in zip(self.instructions, self.path_weights, wsplit):
            mul1, ir1 = self.irreps_in1[ins.i_in1]
            mul2, ir2 = self.irreps_in2[ins.i_in2]
            mul_out, ir_out = self.irreps_out[ins.i_out]
            b1 = x1[..., self._in1_slices[ins.i_in1]].reshape(
                x1.shape[:-1] + (mul1, ir1.dim)
            )
            b2 = x2[..., self._in2_slices[ins.i_in2]].reshape(
                x2.shape[:-1] + (mul2, ir2.dim)
            )
            c = jnp.asarray(wigner_3j(ir1.l, ir2.l, ir_out.l) * pw, dtype=dtype)
            if ins.mode == "uvw":
                if w is None:
                    raise ValueError("uvw instructions require weights")
                # einsum handles both shared [u,v,w] and batched [...,u,v,w]
                res = jnp.einsum("...ui,...vj,ijk,...uvw->...wk", b1, b2, c, w)
            elif ins.mode == "uvu":
                if w is not None:
                    res = jnp.einsum("...ui,...vj,ijk,...uv->...uk", b1, b2, c, w)
                else:
                    res = jnp.einsum("...ui,...vj,ijk->...uk", b1, b2.sum(-2, keepdims=True), c)
            else:
                raise ValueError(ins.mode)
            res = res.reshape(res.shape[:-2] + (mul_out * ir_out.dim,))
            if chunks[ins.i_out] is None:
                chunks[ins.i_out] = res
            else:
                chunks[ins.i_out] = chunks[ins.i_out] + res

        batch_shape = jnp.broadcast_shapes(x1.shape[:-1], x2.shape[:-1])
        out = []
        for i, (mul, ir) in enumerate(self.irreps_out):
            if chunks[i] is None:
                out.append(
                    jnp.zeros(batch_shape + (mul * ir.dim,), dtype=dtype)
                )
            else:
                out.append(jnp.broadcast_to(chunks[i], batch_shape + (mul * ir.dim,)))
        return jnp.concatenate(out, axis=-1) if out else jnp.zeros(
            batch_shape + (0,), dtype=dtype
        )

    def apply_scalar_dense(
        self,
        x1: jnp.ndarray,
        x2: jnp.ndarray,
        weights: jnp.ndarray,
    ) -> jnp.ndarray:
        """FCTP with a single all-scalar (S x 0e) irreps_in2 as dense matmuls.

        Mathematically identical to `apply(x1, x2, weights)` but assembles,
        per scalar channel s, ONE dense [in_dim, out_dim] block-diagonal
        matrix D_s (the l (x) 0e -> l CG is delta/sqrt(2l+1), so every path
        is a channel-mixing matrix replicated over the 2l+1 components) and
        contracts x @ D_s once, masked by x2.

        Rebuilding D from the flat weights every step is an XLA scatter.
        Kept as the reference formulation for regimes where the weights are
        static across many applications (inference serving with frozen
        params can precompute D once); not used by the conv layers. Its
        speed on the GPU is unmeasured (devtools/fctp_bench.py times it).
        """
        assert self.in2_is_onehot_compatible, "plan is not scalar-dense compatible"
        dtype = x1.dtype
        S = self.irreps_in2[0].mul
        dim_i = self.irreps_in1.dim
        dim_o = self.irreps_out.dim
        pos, idx, scale = _scalar_dense_meta(self)
        w_sel = weights[jnp.asarray(idx)] * jnp.asarray(scale)[None, :]  # [S, K]
        d = (
            jnp.zeros((S, dim_i * dim_o), dtype=jnp.float32)
            .at[:, jnp.asarray(pos)]
            .set(w_sel.astype(jnp.float32))
            .reshape(S, dim_i, dim_o)
        )
        # [N, I] x [S, I, O] -> [N, S, O], masked-summed by the scalar
        # channel values (for a one-hot this selects the species block;
        # padded all-zero rows produce zeros, like `apply`)
        y = jax.lax.dot_general(
            x1.astype(jnp.float32), d, (((x1.ndim - 1,), (1,)), ((), ()))
        )
        return jnp.einsum("...so,...s->...o", y, x2.astype(jnp.float32)).astype(
            dtype
        )

    def apply_scalar_matmul(
        self,
        x1: jnp.ndarray,
        x2: jnp.ndarray,
        weights: jnp.ndarray,
        operand_dtype=None,
    ) -> jnp.ndarray:
        """FCTP with all-scalar irreps_in2 reshaped into plain matmuls.

        Mathematically identical to `apply(x1, x2, weights)` for ANY x2
        (one-hot or not): the l (x) 0e -> l CG is delta/sqrt(2l+1), so each
        instruction is a channel-mixing matrix per scalar channel s. Per
        in1 entry, the contraction over channels u runs as ONE
        [B*d, u] @ [u, S*sum(mul_out)] matmul covering all S channels and
        every instruction of that entry at once, then a cheap fused select
        against x2 collapses s.

        Why: `apply`'s einsums lower to B-batched [d, u] x [u, w] matmuls
        whose M dim is the irrep dim (<= 9), too small for a matrix unit.
        This variant keeps M = B*d and N = S*mul_out large. It does S-fold
        more FLOPs than the per-element minimal contraction, so it is only
        used at small S (nn.conv gates on S < 16; the threshold is
        unmeasured on the GPU). `operand_dtype=bfloat16` runs the matmul
        with bf16 operands (f32 accumulation via preferred_element_type).
        """
        assert self.in2_is_onehot_compatible, "plan is not scalar-matmul compatible"
        dtype = x1.dtype
        S = self.irreps_in2[0].mul
        lead = x1.shape[:-1]
        B = int(np.prod(lead)) if lead else 1
        x1f = x1.reshape(B, x1.shape[-1])
        x2f = jnp.broadcast_to(x2, lead + (S,)).reshape(B, S)
        wsplit = self.split_weights(weights)

        groups: Dict[int, List[int]] = {}
        for n, ins in enumerate(self.instructions):
            groups.setdefault(ins.i_in1, []).append(n)

        chunks = [None] * len(self.irreps_out)
        for i_in1, idxs in groups.items():
            mul1, ir1 = self.irreps_in1[i_in1]
            d = ir1.dim
            c0 = float(wigner_3j(ir1.l, 0, ir1.l)[0, 0, 0])
            xe = x1f[:, self._in1_slices[i_in1]].reshape(B, mul1, d)
            xe = jnp.swapaxes(xe, 1, 2).reshape(B * d, mul1)
            wg, outs = [], []
            for n in idxs:
                ins = self.instructions[n]
                mul_out, ir_out = self.irreps_out[ins.i_out]
                scale = self.path_weights[n] * c0
                wg.append(
                    (wsplit[n] * scale).reshape(mul1, S * mul_out).astype(dtype)
                )
                outs.append((ins.i_out, mul_out))
            wgc = jnp.concatenate(wg, axis=1) if len(wg) > 1 else wg[0]
            if operand_dtype is not None:
                y = jax.lax.dot_general(
                    xe.astype(operand_dtype),
                    wgc.astype(operand_dtype),
                    (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32,
                ).astype(dtype)
            else:
                y = xe @ wgc
            off = 0
            for i_out, mul_out in outs:
                seg = y[:, off : off + S * mul_out].reshape(B, d, S, mul_out)
                off += S * mul_out
                res = jnp.einsum("bdsw,bs->bwd", seg, x2f.astype(seg.dtype))
                res = res.reshape(B, mul_out * d)
                chunks[i_out] = res if chunks[i_out] is None else chunks[i_out] + res

        out = []
        for i, (mul, ir) in enumerate(self.irreps_out):
            if chunks[i] is None:
                out.append(jnp.zeros((B, mul * ir.dim), dtype=dtype))
            else:
                out.append(chunks[i].astype(dtype))
        return jnp.concatenate(out, axis=-1).reshape(lead + (self.irreps_out.dim,))

    @property
    def in2_is_onehot_compatible(self) -> bool:
        """True when irreps_in2 is a single scalar (0e) entry — the species
        one-hot case, where `apply_onehot2` avoids the S-fold redundant
        contraction."""
        return (
            len(self.irreps_in2) == 1
            and self.irreps_in2[0].ir == Irrep(0, 1)
            and all(ins.mode == "uvw" and ins.has_weight for ins in self.instructions)
        )

    def apply_onehot2(
        self,
        x1: jnp.ndarray,
        idx: jnp.ndarray,
        weights: jnp.ndarray,
        mask: Optional[jnp.ndarray] = None,
    ) -> jnp.ndarray:
        """Specialized apply for x2 = one_hot(idx) with all-scalar irreps_in2.

        Mathematically identical to `apply(x1, one_hot(idx), weights)` (the
        l (x) 0e -> l CG is delta/sqrt(2l+1)) but gathers the per-species
        weight matrices instead of contracting against the S-wide one-hot —
        an S-fold FLOP reduction for the node-wise mixing FCTPs of the
        convolution. `mask` zeroes rows whose one-hot would be all zeros
        (padded nodes).
        """
        assert self.in2_is_onehot_compatible, "plan is not one-hot specializable"
        dtype = x1.dtype
        wsplit = self.split_weights(weights)
        chunks = [None] * len(self.irreps_out)
        for ins, pw, w in zip(self.instructions, self.path_weights, wsplit):
            mul1, ir1 = self.irreps_in1[ins.i_in1]
            mul_out, ir_out = self.irreps_out[ins.i_out]
            assert ir_out == ir1
            b1 = x1[..., self._in1_slices[ins.i_in1]].reshape(
                x1.shape[:-1] + (mul1, ir1.dim)
            )
            c0 = float(wigner_3j(ir1.l, 0, ir1.l)[0, 0, 0])  # = 1/sqrt(2l+1)
            w_sel = w[:, idx, :]  # [u, N, w_out]
            res = jnp.einsum("nui,unw->nwi", b1, w_sel.astype(dtype)) * (pw * c0)
            res = res.reshape(res.shape[:-2] + (mul_out * ir_out.dim,))
            chunks[ins.i_out] = res if chunks[ins.i_out] is None else chunks[ins.i_out] + res
        out = []
        for i, (mul, ir) in enumerate(self.irreps_out):
            if chunks[i] is None:
                out.append(jnp.zeros(x1.shape[:-1] + (mul * ir.dim,), dtype=dtype))
            else:
                out.append(chunks[i])
        res = jnp.concatenate(out, axis=-1)
        if mask is not None:
            res = res * mask[:, None].astype(dtype)
        return res

    def __repr__(self) -> str:
        return (
            f"TensorProductPlan({self.irreps_in1} x {self.irreps_in2} "
            f"-> {self.irreps_out} | {len(self.instructions)} paths, "
            f"{self.weight_numel} weights)"
        )


@functools.lru_cache(maxsize=None)
def _scalar_dense_meta(plan: "TensorProductPlan"):
    """Static scatter metadata for apply_scalar_dense.

    Returns (pos [K], idx [S, K], scale [K]) numpy arrays:
      pos:   flat positions row*dim_o + col of each weight entry in the
             [dim_in1, dim_out] dense block-diagonal matrix
      idx:   flat indices into the weight vector per scalar channel s
             (uvw weight layout is (mul1, S, mul_out))
      scale: CG * path_weight factor per entry (wigner(l,0,l) is diagonal
             and m-independent)
    """
    dim_o = plan.irreps_out.dim
    out_slices = plan.irreps_out.slices()
    S = plan.irreps_in2[0].mul
    pos, base, sstride, scale = [], [], [], []
    w_off = 0
    for ins, pw, wshape in zip(plan.instructions, plan.path_weights, plan.weight_shapes):
        mul1, ir1 = plan.irreps_in1[ins.i_in1]
        mul_out, ir_out = plan.irreps_out[ins.i_out]
        assert ins.mode == "uvw" and ir_out == ir1
        d = ir1.dim
        c0 = float(wigner_3j(ir1.l, 0, ir1.l)[0, 0, 0]) * pw
        i_off = plan._in1_slices[ins.i_in1].start
        o_off = out_slices[ins.i_out].start
        u, w, m = np.meshgrid(
            np.arange(mul1), np.arange(mul_out), np.arange(d), indexing="ij"
        )
        row = i_off + u * d + m
        col = o_off + w * d + m
        pos.append((row * dim_o + col).reshape(-1))
        base.append((w_off + u * S * mul_out + w).reshape(-1))
        sstride.append(np.full(mul1 * mul_out * d, mul_out, dtype=np.int64))
        scale.append(np.full(mul1 * mul_out * d, c0, dtype=np.float32))
        w_off += int(np.prod(wshape))
    pos = np.concatenate(pos).astype(np.int32)
    base = np.concatenate(base)
    sstride = np.concatenate(sstride)
    idx = (base[None, :] + np.arange(S)[:, None] * sstride[None, :]).astype(np.int32)
    return pos, idx, np.concatenate(scale)


def fully_connected_tp_plan(
    irreps_in1: Irreps, irreps_in2: Irreps, irreps_out: Irreps
) -> TensorProductPlan:
    """All allowed uvw paths into irreps_out (e3nn FullyConnectedTensorProduct).

    Reference usage: self-connection / lin1 / lin2 of the point convolution
    (nn/conv.py:59,77,84).
    """
    irreps_in1 = Irreps(irreps_in1)
    irreps_in2 = Irreps(irreps_in2)
    irreps_out = Irreps(irreps_out)
    instructions = [
        Instruction(i, j, k, "uvw", True)
        for i, (_, ir1) in enumerate(irreps_in1)
        for j, (_, ir2) in enumerate(irreps_in2)
        for k, (_, ir_out) in enumerate(irreps_out)
        if ir_out in ir1 * ir2
    ]
    return TensorProductPlan(irreps_in1, irreps_in2, irreps_out, instructions)


def uvu_tp_plan(
    irreps_in1: Irreps, irreps_in2: Irreps, irreps_out_filter: Irreps
) -> TensorProductPlan:
    """Channel-wise (uvu) weighted TP with the reference's path selection.

    Enumerates l1 (x) l2 -> l3 paths and keeps those with l3 in
    `irreps_out_filter` or l3 == 0e; output entries sorted by irrep so same
    types are adjacent (mirrors reference nn/utils.py:205-232). The actual
    output irreps (`plan.irreps_out`) may differ from the filter.
    """
    irreps_in1 = Irreps(irreps_in1)
    irreps_in2 = Irreps(irreps_in2)
    irreps_out_filter = Irreps(irreps_out_filter)

    irreps_mid = []
    instructions = []
    for i, (mul, ir1) in enumerate(irreps_in1):
        for j, (_, ir2) in enumerate(irreps_in2):
            for ir_out in ir1 * ir2:
                if ir_out in irreps_out_filter or ir_out == Irrep(0, 1):
                    k = len(irreps_mid)
                    irreps_mid.append((mul, ir_out))
                    instructions.append(Instruction(i, j, k, "uvu", True))
    if not irreps_mid:
        raise ValueError(
            f"{irreps_in1} x {irreps_in2} produces no paths into {irreps_out_filter}"
        )
    irreps_mid, perm, _ = Irreps(irreps_mid).sort()
    instructions = [
        Instruction(ins.i_in1, ins.i_in2, perm[ins.i_out], ins.mode, ins.has_weight)
        for ins in instructions
    ]
    return TensorProductPlan(irreps_in1, irreps_in2, irreps_mid, instructions)


class LinearPlan:
    """Equivariant linear map (e3nn o3.Linear equivalent, no bias).

    Connects every input entry to every output entry of the same irrep;
    forward scaled by 1/sqrt(fan_in) per output entry with weights N(0,1).
    Reference usage: nn/nodewise.py:111, model_factory/tfn_scalar_tensor.py:50.
    """

    def __init__(self, irreps_in: Irreps, irreps_out: Irreps):
        self.irreps_in = Irreps(irreps_in)
        self.irreps_out = Irreps(irreps_out)
        self.connections: List[Tuple[int, int]] = [
            (i, j)
            for i, (_, ir_in) in enumerate(self.irreps_in)
            for j, (_, ir_out) in enumerate(self.irreps_out)
            if ir_in == ir_out
        ]
        self.weight_shapes = [
            (self.irreps_in[i].mul, self.irreps_out[j].mul)
            for i, j in self.connections
        ]
        self.weight_numel = int(sum(int(np.prod(s)) for s in self.weight_shapes))
        # fan-in per output entry: total input multiplicity of the same irrep
        self._fan_in = [
            sum(
                self.irreps_in[i].mul
                for i, jj in self.connections
                if jj == j
            )
            for j in range(len(self.irreps_out))
        ]
        self._in_slices = self.irreps_in.slices()
        self._out_slices = self.irreps_out.slices()

    def apply(self, x: jnp.ndarray, weights: jnp.ndarray) -> jnp.ndarray:
        dtype = x.dtype
        chunks = [None] * len(self.irreps_out)
        wi = 0
        for (i, j), shape in zip(self.connections, self.weight_shapes):
            mul_in, ir = self.irreps_in[i]
            mul_out, _ = self.irreps_out[j]
            n = mul_in * mul_out
            w = weights[wi : wi + n].reshape(mul_in, mul_out)
            wi += n
            blk = x[..., self._in_slices[i]].reshape(x.shape[:-1] + (mul_in, ir.dim))
            res = jnp.einsum("...ui,uv->...vi", blk, w.astype(dtype))
            res = res / np.sqrt(self._fan_in[j])
            res = res.reshape(res.shape[:-2] + (mul_out * ir.dim,))
            chunks[j] = res if chunks[j] is None else chunks[j] + res
        out = []
        for j, (mul, ir) in enumerate(self.irreps_out):
            if chunks[j] is None:
                out.append(jnp.zeros(x.shape[:-1] + (mul * ir.dim,), dtype=dtype))
            else:
                out.append(chunks[j])
        return jnp.concatenate(out, axis=-1)

    def __repr__(self) -> str:
        return f"LinearPlan({self.irreps_in} -> {self.irreps_out}, {self.weight_numel} weights)"
