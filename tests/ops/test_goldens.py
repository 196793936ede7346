"""Convention-freeze golden tests.

Recorded by devtools/make_goldens.py (see its docstring): these values pin
the CG signs, the l=1 (x, y, z) basis, SH component normalization, the
Cartesian symmetry-adapted bases, uvu path weights and the full model
assembly (init + normalization factors) against silent drift. A failure
here means a convention changed — which silently breaks training dynamics
and every saved checkpoint (README.md "Conventions").
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

GOLDEN = Path(__file__).resolve().parent.parent / "goldens" / "conventions.npz"


@pytest.fixture(scope="module")
def gold():
    assert GOLDEN.exists(), "run devtools/make_goldens.py"
    with np.load(GOLDEN) as f:
        return dict(f)


def test_wigner_3j_frozen(gold):
    from matten_tpu.ops.wigner import wigner_3j

    for key in [k for k in gold if k.startswith("w3j_")]:
        l1, l2, l3 = (int(c) for c in key[len("w3j_"):])
        np.testing.assert_allclose(
            np.asarray(wigner_3j(l1, l2, l3)), gold[key], atol=1e-7, err_msg=key
        )


def test_spherical_harmonics_frozen(gold):
    from matten_tpu.ops.irreps import Irreps
    from matten_tpu.ops.spherical_harmonics import spherical_harmonics

    sh = spherical_harmonics(
        Irreps("0e+1o+2e+3o+4e"),
        jnp.asarray(gold["sh_vecs"]),
        normalize=True,
        normalization="component",
    )
    np.testing.assert_allclose(np.asarray(sh), gold["sh_lmax4"], atol=1e-5)


def test_cartesian_bases_frozen(gold):
    from matten_tpu.ops.cartesian import cartesian_tensor_map

    np.testing.assert_allclose(
        np.asarray(cartesian_tensor_map("ijkl=jikl=klij").basis),
        gold["cart_elastic"],
        atol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(cartesian_tensor_map("ij=ji").basis), gold["cart_nmr"], atol=1e-9
    )


def test_uvu_plan_frozen(gold):
    from matten_tpu.ops.irreps import Irreps
    from matten_tpu.ops.tensor_product import uvu_tp_plan

    plan = uvu_tp_plan(
        Irreps("4x0e+4x0o+2x1o+2x1e+1x2e"), Irreps("0e+1o+2e"),
        Irreps("4x0e+4x0o+2x1o+2x1e+1x2e"),
    )
    np.testing.assert_allclose(
        np.asarray(plan.path_weights), gold["uvu_path_weights"], atol=1e-9
    )
    out = plan.apply(
        jnp.asarray(gold["uvu_x1"]), jnp.asarray(gold["uvu_x2"]),
        jnp.asarray(gold["uvu_w"]),
    )
    np.testing.assert_allclose(np.asarray(out), gold["uvu_out"], atol=1e-5)


def test_model_forward_frozen(gold):
    """Fixed seed + fixed batch -> recorded output and layer-0 features.

    Locks parameter-path naming/RNG folding (nn/module.py), path-weight
    normalization, bessel x sqrt(N),
    1/sqrt(avg_num_neigh), gate wiring and readout ordering all at once."""
    from matten_tpu.models import create_scalar_tensor_model

    hparams = dict(
        species_embedding_dim=8,
        irreps_edge_sh="0e+1o+2e+3o+4e",
        num_radial_basis=8,
        radial_basis_start=0.0,
        radial_basis_end=5.0,
        radial_basis_type="bessel",
        num_layers=2,
        invariant_layers=2,
        invariant_neurons=8,
        average_num_neighbors=20.0,
        conv_layer_irreps="4x0o+4x0e+2x1o+2x1e+1x2o+1x2e+1x3o+1x3e+1x4e",
        nonlinearity_type="gate",
        normalization="batch",
        conv_to_output_hidden_irreps_out="4x0e+2x2e+4e",
        output_format="irreps",
        output_formula="ijkl=jikl=klij",
        reduce="mean",
    )
    model = create_scalar_tensor_model(
        hparams,
        dict(allowed_species=[8, 14], average_num_neighbors=20.0, atom_feats_size=None),
    )
    data = {
        k[len("in_"):]: jnp.asarray(v) for k, v in gold.items() if k.startswith("in_")
    }
    variables = model.init(jax.random.PRNGKey(20260819), data)
    out, inter = model.apply(
        variables, data, use_running_average=True,
        capture_intermediates=lambda mdl, name: name == "__call__",
    )
    np.testing.assert_allclose(np.asarray(out), gold["model_out"], atol=2e-5)
    feats = inter["intermediates"]["backbone"]["layers_3"]["__call__"][0][
        "node_features"
    ]
    np.testing.assert_allclose(
        np.asarray(feats), gold["layer0_node_features"], atol=2e-5
    )
