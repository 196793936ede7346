"""Mesh layouts with batch norm and Adam against their one-device reference
step, on virtual CPU devices."""

import jax
import numpy as np
import pytest

from matten_tpu.data.graph import CrystalGraph
from matten_tpu.data.structure import Structure
from matten_tpu.nn.embedding import atomic_number_map
from matten_tpu.train import CanonicalRegressionTask, TrainerConfig
from matten_tpu.train.config import MeshSpec
from matten_tpu.train.layouts import (
    data_shards,
    layout_batch,
    layout_trainer,
    reference_step,
)

HPARAMS = dict(
    species_embedding_dim=4,
    irreps_edge_sh="0e+1o+2e",
    num_radial_basis=4,
    radial_basis_start=0.0,
    radial_basis_end=5.0,
    radial_basis_type="bessel",
    num_layers=2,
    invariant_layers=1,
    invariant_neurons=8,
    average_num_neighbors=20.0,
    conv_layer_irreps="4x0o+4x0e+2x1o+2x1e",
    nonlinearity_type="gate",
    normalization="batch",
    conv_to_output_hidden_irreps_out="4x0e+2x2e+4e",
    output_format="irreps",
    output_formula="ijkl=jikl=klij",
    reduce="mean",
)
DS = {"allowed_species": [8, 14], "average_num_neighbors": 20.0, "atom_feats_size": None}
CONFIG = TrainerConfig(max_epochs=1, lr=0.01, weight_decay=1e-5)  # Adam


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    graphs = []
    for n in (3, 4, 5, 4, 6, 3, 5, 4):
        s = Structure(
            lattice=np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2,
            frac_coords=rng.uniform(0, 1, size=(n, 3)),
            atomic_numbers=rng.choice([8, 14], size=n),
        )
        g = CrystalGraph.from_structure(s, r_cut=5.0)
        g.y["elastic_tensor_full"] = rng.normal(size=(1, 21))
        graphs.append(g)
    smap = atomic_number_map((8, 14))
    task = CanonicalRegressionTask(name="elastic_tensor_full")
    single = layout_trainer(HPARAMS, DS, [task], CONFIG)
    state0 = jax.device_get(single.init_state(layout_batch(graphs, smap), rng_seed=0))
    return graphs, smap, task, single, state0


def _fresh(state0):
    return jax.tree.map(np.copy, state0)


def _close(a, b, atol):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol, rtol=1e-5)


def test_one_shard_reference_is_the_one_device_step(setup):
    graphs, smap, _, single, state0 = setup
    batch = layout_batch(graphs, smap)
    want, want_loss, _ = single._train_step(_fresh(state0), *single._to_device(batch))
    got, loss = reference_step(single, _fresh(state0), data_shards(graphs, smap, 1))
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    _close(got.params, want.params, 1e-6)
    _close(got.batch_stats, want.batch_stats, 1e-6)
    _close(got.opt_state, want.opt_state, 1e-6)


def test_data_shards_are_the_strided_split(setup):
    graphs, smap, *_ = setup
    shards = data_shards(graphs, smap, 4)
    assert len(shards) == 4
    for s, (d, _) in enumerate(shards):
        assert int(d["node_mask"].sum()) == sum(g.num_nodes for g in graphs[s::4])
        assert int(d["graph_mask"].sum()) == 2
    # one pad shape for every shard
    assert len({d["edge_index"].shape for d, _ in shards}) == 1


@pytest.mark.parametrize(
    "n_data, n_graph, mode",
    [(4, 1, "edge"), (2, 2, "edge"), (2, 2, "node"), (2, 2, "node_ring"), (1, 4, "node")],
)
def test_mesh_step_matches_the_reference(setup, n_data, n_graph, mode):
    graphs, smap, task, single, state0 = setup
    spec = MeshSpec(n_data=n_data, n_graph=n_graph, mode=mode)
    trainer = layout_trainer(HPARAMS, DS, [task], CONFIG, spec)
    d, t = trainer._to_device(layout_batch(graphs, smap, spec))
    # ahead-of-time compiled, as chip_smoke.py --four runs it
    step = trainer._train_step.lower(_fresh(state0), d, t).compile()
    new, loss, _ = step(_fresh(state0), d, t)
    ref, ref_loss = reference_step(single, _fresh(state0), data_shards(graphs, smap, n_data))
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    # the gradient: Adam's first moment after one step
    _close(new.opt_state, ref.opt_state, 1e-6)
    _close(new.batch_stats, ref.batch_stats, 1e-6)
    _close(new.params, ref.params, 1e-5)


def test_ring_shards_share_one_slot_capacity():
    # data shard 0 gets the small crystals, shard 1 the large ones: their
    # ring slots need different capacities, and the stacked batch one
    rng = np.random.default_rng(5)
    graphs = []
    for i in range(8):
        n = 2 if i % 2 == 0 else 12
        s = Structure(
            lattice=np.eye(3) * (3.5 if n == 12 else 5.0),
            frac_coords=rng.uniform(0, 1, size=(n, 3)),
            atomic_numbers=rng.choice([8, 14], size=n),
        )
        g = CrystalGraph.from_structure(s, r_cut=5.0)
        g.y["elastic_tensor_full"] = rng.normal(size=(1, 21))
        graphs.append(g)
    spec = MeshSpec(n_data=2, n_graph=2, mode="node_ring")
    data, _ = layout_batch(graphs, atomic_number_map((8, 14)), spec)
    assert data["edge_index"].shape[:3] == (2, 2, 2)
    assert int(data["edge_mask"].sum()) == sum(g.num_edges for g in graphs)
