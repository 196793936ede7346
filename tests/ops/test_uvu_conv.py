"""The plain uvu convolution (`uvu_plan.apply` + `scatter_sum`) of every
production layer against a CG-table reference, forward and gradient.

The reference is independent of `TensorProductPlan.apply`: it enumerates the
nonzero Wigner-3j entries of every instruction as flat index arrays over
the irreps layouts and the weight layout, and accumulates in float64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from matten_tpu.nn.conv import PointConv, PointConvWithActivation
from matten_tpu.ops.scatter import scatter_sum
from matten_tpu.ops.wigner import wigner_3j

# scripts/configs/materials_tensor_production.yaml model widths
PRODUCTION = dict(
    species_embedding_dim=16,
    irreps_edge_sh="0e+1o+2e+3o+4e",
    num_radial_basis=8,
    num_layers=3,
    invariant_layers=2,
    invariant_neurons=32,
    average_num_neighbors=30.0,
    conv_layer_irreps="32x0o+32x0e+16x1o+16x1e+4x2o+4x2e+2x3o+2x3e+2x4e",
    nonlinearity_type="gate",
    normalization="batch",
    conv_to_output_hidden_irreps_out="16x0e+2x2e+4e",
    output_formula="ijkl=jikl=klij",
)
LAYERS = ("layer0_convnet", "layer1_convnet", "layer2_convnet", "conv_layer_last")
N_NODES, N_EDGES = 10, 24


@functools.lru_cache(maxsize=None)
def _uvu_plans():
    from matten_tpu.models import create_scalar_tensor_model

    model = create_scalar_tensor_model(
        PRODUCTION, {"allowed_species": [8, 13, 14, 22, 56], "average_num_neighbors": 30.0}
    )
    plans = {}
    for layer in model.backbone.layers:
        if isinstance(layer, PointConvWithActivation):
            layer = PointConv(
                irreps_in=layer.irreps_in, conv_layer_irreps=layer._act_info().irreps_in
            )
        elif not isinstance(layer, PointConv):
            continue
        plans[len(plans)] = layer._plans()[2]
    return {name: plans[i] for i, name in enumerate(LAYERS)}


def _cg_index(plan):
    """Flat (out, in1, in2, weight, coefficient) arrays of every nonzero term."""
    s1, s2, so = plan.irreps_in1.slices(), plan.irreps_in2.slices(), plan.irreps_out.slices()
    cols = [[], [], [], [], []]
    w_off = 0
    for ins, pw, shape in zip(plan.instructions, plan.path_weights, plan.weight_shapes):
        mul1, ir1 = plan.irreps_in1[ins.i_in1]
        mul2, ir2 = plan.irreps_in2[ins.i_in2]
        _, ir3 = plan.irreps_out[ins.i_out]
        c = np.asarray(wigner_3j(ir1.l, ir2.l, ir3.l), np.float64) * pw
        for i, j, k in zip(*np.nonzero(np.abs(c) > 1e-12)):
            for u in range(mul1):
                for v in range(mul2):
                    cols[0].append(so[ins.i_out].start + u * ir3.dim + k)
                    cols[1].append(s1[ins.i_in1].start + u * ir1.dim + i)
                    cols[2].append(s2[ins.i_in2].start + v * ir2.dim + j)
                    cols[3].append(w_off + u * mul2 + v)
                    cols[4].append(c[i, j, k])
        w_off += int(np.prod(shape))
    return [np.asarray(x) for x in cols]


def _reference(plan, x, sh, w, src, dst, g):
    """Output and (dx, dw) cotangents for cotangent g, in float64."""
    o, i1, i2, iw, c = _cg_index(plan)
    xe = x[src]
    msg = np.zeros((len(src), plan.irreps_out.dim))
    np.add.at(msg.T, o, (c * xe[:, i1] * sh[:, i2] * w[:, iw]).T)
    out = np.zeros((N_NODES, plan.irreps_out.dim))
    np.add.at(out, dst, msg)
    ge = g[dst][:, o]
    dxe = np.zeros_like(xe)
    np.add.at(dxe.T, i1, (c * ge * sh[:, i2] * w[:, iw]).T)
    dx = np.zeros_like(x)
    np.add.at(dx, src, dxe)
    dw = np.zeros_like(w)
    np.add.at(dw.T, iw, (c * ge * xe[:, i1] * sh[:, i2]).T)
    return out, dx, dw


@functools.lru_cache(maxsize=None)
def _results(layer):
    plan = _uvu_plans()[layer]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N_NODES, plan.irreps_in1.dim))
    sh = rng.normal(size=(N_EDGES, plan.irreps_in2.dim))
    w = rng.normal(size=(N_EDGES, plan.weight_numel))
    src = rng.integers(0, N_NODES, N_EDGES)
    dst = np.sort(rng.integers(0, N_NODES, N_EDGES))
    g = rng.normal(size=(N_NODES, plan.irreps_out.dim))

    def conv(x, w):
        return scatter_sum(plan.apply(x[src], jnp.asarray(sh, jnp.float32), w), dst, N_NODES)

    @jax.jit
    def fwd_bwd(x, w, g):
        out, vjp = jax.vjp(conv, x, w)
        return (out,) + vjp(g)

    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        got = [np.asarray(a, np.float64) for a in fwd_bwd(f32(x), f32(w), f32(g))]
    return got, _reference(plan, x, sh, w, src, dst, g)


def test_production_plan_sizes():
    plans = _uvu_plans()
    assert [len(plans[k].instructions) for k in LAYERS] == [5, 59, 99, 103]
    assert plans["conv_layer_last"].irreps_out.dim == 4170


@pytest.mark.parametrize("quantity", ["forward", "grad_x", "grad_w"])
@pytest.mark.parametrize("layer", LAYERS)
def test_uvu_conv_matches_cg_reference(layer, quantity):
    got, ref = _results(layer)
    k = ["forward", "grad_x", "grad_w"].index(quantity)
    err = np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()
    assert err < 1e-5, (layer, quantity, err)
