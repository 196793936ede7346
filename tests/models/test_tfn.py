"""End-to-end model tests: the equivariance crown jewel + invariances.

Mirrors the reference's centerpiece test (tests/model/test_tfn_tensor.py:
98-139): build a real model, run the full data pipeline on a crystal, apply
a random O(3) rotation to the *structure*, and assert the predicted tensor
transforms covariantly; plus static-shape invariances the reference cannot
test (padding invariance, atom-permutation invariance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from matten_tpu.data.graph import CrystalGraph, PadSpec, collate_graphs
from matten_tpu.data.structure import Structure
from matten_tpu.models import (
    create_atomic_tensor_model,
    create_scalar_tensor_model,
)
from matten_tpu.nn.embedding import atomic_number_map
from matten_tpu.ops.cartesian import cartesian_tensor_map
from matten_tpu.ops.wigner import irreps_rotation, random_rotation

HPARAMS = dict(
    species_embedding_dim=16,
    irreps_edge_sh="0e+1o+2e",
    num_radial_basis=8,
    radial_basis_start=0.0,
    radial_basis_end=5.0,
    radial_basis_type="bessel",
    num_layers=2,
    invariant_layers=2,
    invariant_neurons=16,
    average_num_neighbors=30.0,
    conv_layer_irreps="8x0o+8x0e+4x1o+4x1e+2x2o+2x2e",
    nonlinearity_type="gate",
    normalization="batch",
    conv_to_output_hidden_irreps_out="8x0e+2x2e+4e",
    output_format="irreps",
    output_formula="ijkl=jikl=klij",
    reduce="mean",
)
DS_HPARAMS = dict(allowed_species=[8, 22, 56], average_num_neighbors=30.0)
SPECIES_MAP = atomic_number_map((8, 22, 56))


def _structure(rng):
    return Structure(
        lattice=np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1,
        frac_coords=[
            [0, 0, 0],
            [0.52, 0.48, 0.5],
            [0.5, 0.45, 0],
            [0.5, 0, 0.55],
            [0, 0.5, 0.5],
        ],
        atomic_numbers=[56, 22, 8, 8, 8],
    )


def _batch(structs, pad=PadSpec(64, 512, 8)):
    graphs = [CrystalGraph.from_structure(s, r_cut=5.0) for s in structs]
    data, _ = collate_graphs(graphs, pad, species_map=SPECIES_MAP)
    return {k: jnp.asarray(v) for k, v in data.items()}


class TestScalarTensorModel:
    @pytest.fixture(scope="class")
    def model_and_vars(self):
        model = create_scalar_tensor_model(HPARAMS, DS_HPARAMS)
        rng = np.random.default_rng(0)
        data = _batch([_structure(rng)])
        variables = model.init(jax.random.PRNGKey(0), data)
        return model, variables

    def test_equivariance_under_structure_rotation(self, model_and_vars):
        model, variables = model_and_vars
        rng = np.random.default_rng(1)
        s = _structure(rng)
        out = np.asarray(
            model.apply(variables, _batch([s]), use_running_average=True)
        )[0]
        r = random_rotation(rng)
        out_r = np.asarray(
            model.apply(variables, _batch([s.rotate(r)]), use_running_average=True)
        )[0]
        d = irreps_rotation(cartesian_tensor_map("ijkl=jikl=klij").irreps, r)
        np.testing.assert_allclose(out_r, d @ out, atol=1e-4)

    def test_output_cartesian_symmetries(self):
        hp = dict(HPARAMS, output_format="cartesian")
        model = create_scalar_tensor_model(hp, DS_HPARAMS)
        rng = np.random.default_rng(2)
        data = _batch([_structure(rng)])
        variables = model.init(jax.random.PRNGKey(0), data)
        t = np.asarray(model.apply(variables, data, use_running_average=True))
        assert t.shape[1:] == (3, 3, 3, 3)
        np.testing.assert_allclose(t, t.transpose(0, 2, 1, 3, 4), atol=1e-5)
        np.testing.assert_allclose(t, t.transpose(0, 1, 2, 4, 3), atol=1e-5)
        np.testing.assert_allclose(t, t.transpose(0, 3, 4, 1, 2), atol=1e-5)

    def test_atom_permutation_invariance(self, model_and_vars):
        model, variables = model_and_vars
        rng = np.random.default_rng(3)
        s = _structure(rng)
        perm = rng.permutation(len(s))
        s2 = Structure(s.lattice, s.frac_coords[perm], s.atomic_numbers[perm])
        out = model.apply(variables, _batch([s]), use_running_average=True)
        out2 = model.apply(variables, _batch([s2]), use_running_average=True)
        np.testing.assert_allclose(np.asarray(out)[0], np.asarray(out2)[0], atol=1e-5)

    def test_padding_invariance(self, model_and_vars):
        model, variables = model_and_vars
        rng = np.random.default_rng(4)
        s = _structure(rng)
        out_a = model.apply(
            variables, _batch([s], PadSpec(64, 512, 8)), use_running_average=True
        )
        out_b = model.apply(
            variables, _batch([s], PadSpec(96, 1024, 4)), use_running_average=True
        )
        np.testing.assert_allclose(
            np.asarray(out_a)[0], np.asarray(out_b)[0], atol=1e-5
        )

    def test_batching_consistency(self, model_and_vars):
        """A graph predicts the same alone or batched with others."""
        model, variables = model_and_vars
        rng = np.random.default_rng(5)
        s1, s2 = _structure(rng), _structure(rng)
        out_both = np.asarray(
            model.apply(variables, _batch([s1, s2]), use_running_average=True)
        )
        out_1 = np.asarray(
            model.apply(variables, _batch([s1]), use_running_average=True)
        )[0]
        np.testing.assert_allclose(out_both[0], out_1, atol=1e-5)


class TestAtomicTensorModel:
    def test_per_node_equivariance(self):
        hp = dict(
            HPARAMS,
            output_formula="ij=ji",
            conv_layer_irreps="8x0o+8x0e+4x1o+4x1e+2x2o+2x2e",
        )
        model = create_atomic_tensor_model(hp, DS_HPARAMS)
        rng = np.random.default_rng(6)
        s = _structure(rng)
        data = _batch([s])
        variables = model.init(jax.random.PRNGKey(0), data)
        out = np.asarray(model.apply(variables, data, use_running_average=True))
        assert out.shape == (64, 6)  # per padded node, 0e+2e
        r = random_rotation(rng)
        out_r = np.asarray(
            model.apply(variables, _batch([s.rotate(r)]), use_running_average=True)
        )
        d = irreps_rotation(cartesian_tensor_map("ij=ji").irreps, r)
        n = len(s)
        np.testing.assert_allclose(out_r[:n], out[:n] @ d.T, atol=1e-4)
