"""The .npz checkpoint format: round trip, best-k, `last`/resume, and the
template-free restore that `predict` uses."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from matten_tpu.train.checkpoint import (
    CheckpointManager,
    load_state,
    load_variables,
    save_state,
)
from matten_tpu.train.trainer import Trainer, TrainState


def _state(seed=0):
    rng = np.random.default_rng(seed)
    params = {
        "backbone": {
            "layers_0": {"linear": {"kernel": rng.normal(size=(3, 4)), "bias": np.zeros(4)}},
            "layers_3": {"conv": {"w_sc": rng.normal(size=(7,))}},
        },
        "w_out": rng.normal(size=(5,)),
    }
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    batch_stats = {"backbone": {"layers_3": {"norm": {"running_var": jnp.ones(4)}}}}
    tx = optax.inject_hyperparams(Trainer._make_tx)(learning_rate=0.01, weight_decay=1e-5)
    return TrainState(
        step=jnp.asarray(seed, jnp.int32),
        params=params,
        batch_stats=batch_stats,
        opt_state=tx.init(params),
    )


def _assert_same(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_state_round_trip(tmp_path):
    state = _state(3)
    save_state(tmp_path / "ck", state)
    assert (tmp_path / "ck" / "state.npz").exists()
    assert not (tmp_path / "ck_tmp").exists()
    _assert_same(load_state(tmp_path / "ck", _state(0)), state)


@pytest.mark.parametrize("committed", [False, True])
def test_restore_keeps_the_template_placement(tmp_path, committed):
    # jit keys its compiled programs on committedness: a restored state must
    # reuse the programs compiled for the template
    template = _state(0)
    if committed:
        template = jax.device_put(template, jax.devices()[0])
    save_state(tmp_path / "ck", _state(2))
    restored = load_state(tmp_path / "ck", template)
    for ref, got in zip(jax.tree.leaves(template), jax.tree.leaves(restored)):
        assert got.committed == ref.committed == committed
        assert got.sharding == ref.sharding


def test_restore_rejects_other_shapes(tmp_path):
    save_state(tmp_path / "ck", _state(1))
    other = _state(1).replace(params={**_state(1).params, "w_out": jnp.zeros(6)})
    with pytest.raises(ValueError, match="w_out"):
        load_state(tmp_path / "ck", other)


def test_best_k_keeps_lowest_scores(tmp_path):
    mgr = CheckpointManager(tmp_path, save_top_k=2)
    for epoch, score in enumerate([5.0, 3.0, 4.0, 1.0, 2.0]):
        mgr.save(epoch, _state(epoch), {"val/score": score})
    assert sorted(p.name for p in tmp_path.glob("epoch_*")) == ["epoch_3", "epoch_4"]
    assert json.loads((tmp_path / "index.json").read_text()) == {"3": 1.0, "4": 2.0}
    assert CheckpointManager(tmp_path).best_epoch == 3
    _assert_same(mgr.restore(_state(0)), _state(3))
    _assert_same(mgr.restore(_state(0), epoch=4), _state(4))


def test_last_and_loop_state_resume(tmp_path):
    mgr = CheckpointManager(tmp_path)
    assert not mgr.has_last()
    mgr.save_last(_state(7), {"epoch": 7, "best_score": 0.5})
    mgr.save_last(_state(8), {"epoch": 8, "best_score": 0.25})
    again = CheckpointManager(tmp_path)
    assert again.has_last()
    assert again.load_loop_state() == {"epoch": 8, "best_score": 0.25}
    _assert_same(again.restore(_state(0), last=True), _state(8))
    # no best epoch recorded: predict falls back to `last`
    assert again.best_path() == tmp_path.absolute() / "last"


def test_template_free_variables_for_predict(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, _state(2), {"val/score": 1.0})
    variables = load_variables(mgr.best_path())
    assert set(variables) == {"params", "batch_stats"}
    _assert_same(variables["params"], jax.device_get(_state(2).params))
    _assert_same(variables["batch_stats"], jax.device_get(_state(2).batch_stats))


def test_trainer_state_is_a_pytree_with_replace():
    state = _state(1)
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    names = {jax.tree_util.keystr(p[:1]) for p, _ in leaves}
    assert names == {".step", ".params", ".batch_stats", ".opt_state"}
    assert int(state.replace(step=jnp.asarray(9)).step) == 9


def _write(kind, directory):
    from matten_tpu.train.checkpoint import save_sidecar

    if kind == "state":
        save_state(directory / "ck", _state(1))
    elif kind == "best":
        CheckpointManager(directory).save(0, _state(1), {"val/score": 1.0})
    elif kind == "last":
        CheckpointManager(directory).save_last(_state(1), {"epoch": 1})
    else:
        save_sidecar(directory, {"model": {}}, {"mean": np.zeros(3)})


@pytest.mark.parametrize("kind", ["state", "best", "last", "sidecar"])
def test_only_the_primary_process_writes(tmp_path, monkeypatch, kind):
    from matten_tpu.train import checkpoint

    barriers = []
    monkeypatch.setattr(checkpoint, "_barrier", barriers.append)
    monkeypatch.setattr(checkpoint, "is_primary_host", lambda: False)
    _write(kind, tmp_path / "other")
    assert not any(p.is_file() for p in (tmp_path / "other").rglob("*"))
    monkeypatch.setattr(checkpoint, "is_primary_host", lambda: True)
    _write(kind, tmp_path / "primary")
    assert any(p.is_file() for p in (tmp_path / "primary").rglob("*"))
    # both processes met at one barrier per file set
    assert len(barriers) == 2 and barriers[0].split()[0] == barriers[1].split()[0]


@pytest.mark.parametrize("processes", [1, 2])
def test_barrier_only_across_processes(monkeypatch, processes):
    from jax.experimental import multihost_utils

    from matten_tpu.train import checkpoint

    calls = []
    monkeypatch.setattr(jax, "process_count", lambda: processes)
    monkeypatch.setattr(multihost_utils, "sync_global_devices", calls.append)
    checkpoint._barrier("checkpoint x")
    assert calls == (["checkpoint x"] if processes > 1 else [])


def test_sharded_leaves_are_saved_whole(tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from matten_tpu.parallel.sharding import make_mesh

    mesh = make_mesh(n_data=4, n_graph=1)
    state = _state(2)
    w = jax.device_put(jnp.arange(8.0), NamedSharding(mesh, P("data")))
    state = state.replace(params=dict(state.params, w_out=w))
    save_state(tmp_path / "ck", state)
    with np.load(tmp_path / "ck" / "state.npz") as f:
        np.testing.assert_array_equal(f["params/w_out"], np.arange(8.0))
