"""Smoke run of the training and predict path on the GPU.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # four cards: the mesh layouts vs one card

One card, in one process:
  1. environment: JAX, devices, the card's name and power limit, the compile
     cache, and the third-party packages the main path imports;
  2. train: `scripts/train_materials_tensor.main` on a seeded synthetic
     elasticity set with the production model at full width (batch 32), the
     step's compile time, steady time, edges/s and peak memory, then a few
     steps of `scripts/train_atomic_tensor.main` (NMR) at
     `atomic_tensor.yaml` widths;
  3. predict: `predict()` on 8 structures of mixed sizes, checked against a
     direct `model.apply` of the restored best checkpoint, at the default
     precision and at `highest`;
  4. numerics: forward and loss gradient of the production model on one
     batch, on the GPU at `highest` and at the default matmul precision
     (TF32), against the host CPU at `highest`.

`--four` runs one production train step (full width, batch norm, Adam) per
mesh layout that users set through `trainer.mesh` (data=4; data=2 x graph=2
in the edge, node and node_ring modes) and compares each with the same step
of the same global batch on one card: each data shard's sub-batch through
the one-card model, batch statistics per data shard as under the mesh
(`matten_tpu.train.layouts.reference_step`).

The last line of standard output is one JSON object; `"ok": true` only when
every phase passed. Without a GPU, or outside the repository, it exits
non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# model sections of scripts/configs/materials_tensor_production.yaml and
# scripts/configs/atomic_tensor.yaml, verbatim (tests/test_chip_smoke.py)
ELASTICITY_MODEL = {
    "species_embedding_dim": 16,
    "irreps_edge_sh": "0e + 1o + 2e + 3o + 4e",
    "radial_basis_type": "bessel",
    "num_radial_basis": 8,
    "radial_basis_start": 0.0,
    "radial_basis_end": 5.0,
    "num_layers": 3,
    "invariant_layers": 2,
    "invariant_neurons": 32,
    "average_num_neighbors": "auto",
    "conv_layer_irreps": "32x0o+32x0e + 16x1o+16x1e + 4x2o+4x2e + 2x3o+2x3e + 2x4e",
    "nonlinearity_type": "gate",
    "normalization": "batch",
    "conv_to_output_hidden_irreps_out": "16x0e + 2x2e + 4e",
    "output_format": "irreps",
    "output_formula": "ijkl=jikl=klij",
    "reduce": "mean",
}
NMR_MODEL = {
    "species_embedding_dim": 16,
    "irreps_edge_sh": "0e + 1o + 2e",
    "radial_basis_type": "bessel",
    "num_radial_basis": 8,
    "radial_basis_start": 0.0,
    "radial_basis_end": 5.0,
    "num_layers": 3,
    "invariant_layers": 2,
    "invariant_neurons": 32,
    "average_num_neighbors": "auto",
    "conv_layer_irreps": "32x0o+32x0e + 16x1o+16x1e + 4x2o+4x2e",
    "nonlinearity_type": "gate",
    "normalization": "batch",
    "output_format": "irreps",
    "output_formula": "ij=ji",
}

SPECIES = (8, 13, 14, 22, 56)
ATOMS = (4, 12)
N_CRYSTALS = 128
BATCH = 32
EPOCHS = 3
SCAN_STEPS = 8
N_NMR = 16
NMR_BATCH = 8
N_PREDICT = 8
TIMED_STEPS = 20
SEED = 35

# GPU vs CPU, both at `highest`: float32 sums in another order, with atomics
# in the scatter
TOL_HIGHEST = 1e-4
# GPU at its default precision: float32 dots run as TF32
TOL_DEFAULT = 5e-2
# predict() against a direct apply of the restored state, at one precision,
# relative to max |value|: at `highest`; and at the default precision, where
# the two sides round differently at TF32 (unit roundoff 2**-11; 9.533e-05
# and 1.020e-04 measured on an H100)
TOL_PREDICT = {"highest": 1e-5, "default": 1e-3}

FOUR_LAYOUTS = (
    {"data": 4, "graph": 1, "mode": "edge"},
    {"data": 2, "graph": 2, "mode": "edge"},
    {"data": 2, "graph": 2, "mode": "node"},
    {"data": 2, "graph": 2, "mode": "node_ring"},
)
# --four compiles its seven cold programs at once; XLA's GEMM autotuning is
# off there to bound the time that takes
FOUR_XLA_FLAGS = "--xla_gpu_autotune_level=0"
# packages that must stay off the main path (the card's machine lacks them)
OFF_PATH = ("flax", "orbax", "pandas", "yaml", "sklearn")


def log(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# synthetic data


def random_structure(rng, n_atoms: int):
    from matten_tpu.data.structure import Structure

    return Structure(
        lattice=np.eye(3) * (3.5 + rng.uniform(0, 1.5)) + rng.normal(size=(3, 3)) * 0.1,
        frac_coords=rng.uniform(0, 1, size=(n_atoms, 3)),
        atomic_numbers=rng.choice(SPECIES, size=n_atoms),
    )


def random_elastic_tensor(rng) -> np.ndarray:
    t = rng.normal(size=(3, 3, 3, 3)) * 50.0
    t = (t + t.transpose(1, 0, 2, 3)) / 2
    t = (t + t.transpose(0, 1, 3, 2)) / 2
    return (t + t.transpose(2, 3, 0, 1)) / 2


def write_table(path: Path, rows) -> None:
    """A pandas-style JSON table in the default `columns` orientation."""
    cols = {k: {str(i): r[k] for i, r in enumerate(rows)} for k in rows[0]}
    path.write_text(json.dumps(cols))


def write_elasticity_set(path: Path, n: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        s = random_structure(rng, int(rng.integers(ATOMS[0], ATOMS[1] + 1)))
        rows.append(
            {
                "structure": s.to_dict(),
                "elastic_tensor_full": random_elastic_tensor(rng).tolist(),
            }
        )
    write_table(path, rows)


def write_nmr_set(path: Path, n: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        s = random_structure(rng, int(rng.integers(ATOMS[0], ATOMS[1] + 1)))
        s.atomic_numbers[0] = 14
        sel = s.atomic_numbers == 14
        t = rng.normal(size=(int(sel.sum()), 3, 3)) * 10.0
        rows.append(
            {
                "structure": s.to_dict(),
                "nmr_tensor": ((t + t.transpose(0, 2, 1)) / 2).tolist(),
                "atom_selector": sel.tolist(),
            }
        )
    write_table(path, rows)


def elasticity_config(root: Path) -> dict:
    """The production config (scripts/configs/materials_tensor_production.yaml)
    with the synthetic set, a temporary checkpoint directory and EPOCHS.
    Unlike the production YAML (num_buckets 4), the loader pads every batch
    to one shape (num_buckets 1), and one file serves all three splits: this
    smoke's choice, so that a cold run compiles each program once."""
    return {
        "seed_everything": SEED,
        "restore": False,
        "data": {
            "root": str(root),
            "tensor_target_name": "elastic_tensor_full",
            "tensor_target_format": "irreps",
            "tensor_target_formula": "ijkl=jikl=klij",
            "normalize_tensor_target": True,
            "trainset_filename": "elasticity.json",
            "valset_filename": "elasticity.json",
            "testset_filename": "elasticity.json",
            "r_cut": 5.0,
            "reuse": True,
            "loader_kwargs": {
                "batch_size": BATCH,
                "shuffle": True,
                "num_buckets": 1,
                "batch_by_size": False,
            },
        },
        "model": dict(ELASTICITY_MODEL),
        "trainer": {
            "max_epochs": EPOCHS,
            "checkpoint_dir": str(root / "ckpt"),
            "devices": 1,
            "scan_steps": SCAN_STEPS,
            "save_last_every_epochs": 10,
            "callbacks": [
                {
                    "class_path": "ModelCheckpoint",
                    "init_args": {"monitor": "val/score", "mode": "min", "save_top_k": 3},
                },
                {
                    "class_path": "EarlyStopping",
                    "init_args": {"monitor": "val/score", "mode": "min", "patience": 150},
                },
            ],
        },
        "optimizer": {
            "class_path": "torch.optim.Adam",
            "init_args": {"lr": 0.01, "weight_decay": 0.00001},
        },
        "lr_scheduler": {
            "class_path": "torch.optim.lr_scheduler.ReduceLROnPlateau",
            "init_args": {"mode": "min", "factor": 0.5, "patience": 50},
        },
    }


def nmr_config(root: Path) -> dict:
    """scripts/configs/atomic_tensor.yaml with the synthetic set, 2 epochs and
    one pad shape."""
    return {
        "seed_everything": SEED,
        "data": {
            "tensor_target_name": "nmr_tensor",
            "atom_selector": "atom_selector",
            "tensor_target_formula": "ij=ji",
            "root": str(root),
            "trainset_filename": "nmr.json",
            "valset_filename": "nmr.json",
            "testset_filename": "nmr.json",
            "r_cut": 5.0,
            "reuse": False,
            "loader_kwargs": {"batch_size": NMR_BATCH, "shuffle": True, "num_buckets": 1},
        },
        "model": dict(NMR_MODEL),
        "trainer": {"max_epochs": 2, "checkpoint_dir": str(root / "ckpt_nmr")},
        "optimizer": {
            "class_path": "torch.optim.Adam",
            "init_args": {"lr": 0.01, "weight_decay": 0.00001},
        },
        "lr_scheduler": {
            "class_path": "torch.optim.lr_scheduler.ReduceLROnPlateau",
            "init_args": {"mode": "min", "factor": 0.5, "patience": 50},
        },
    }


# ---------------------------------------------------------------------------
# helpers


def rel_diff(a, b) -> float:
    """max |a - b| / max |b| over all leaves of two pytrees."""
    import jax

    la = [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(a)]
    lb = [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(b)]
    diff = max(float(np.abs(x - y).max()) for x, y in zip(la, lb))
    ref = max(float(np.abs(y).max()) for y in lb)
    return diff / max(ref, 1e-30)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def timed(fn, n: int) -> float:
    """Seconds per call of `fn` (already compiled), over n calls."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


# ---------------------------------------------------------------------------
# phases


def phase_environment() -> dict:
    import importlib.metadata
    import importlib.util

    import jax

    from matten_tpu.utils.compile_cache import enable_compile_cache

    log(f"jax {jax.__version__}; devices: {jax.devices()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log("nvidia-smi name, power.limit:")
    log(smi)
    cache = enable_compile_cache()
    n_cached = len(list(Path(cache).glob("*"))) if Path(cache).is_dir() else 0
    log(f"compile cache: {cache} ({n_cached} entries before this run)")

    # import the whole main path, then list what it pulled in
    import matten_tpu.data.datamodule  # noqa: F401
    import matten_tpu.models  # noqa: F401
    import matten_tpu.predict  # noqa: F401
    import matten_tpu.train  # noqa: F401

    sys.path.insert(0, str(REPO / "scripts"))
    import train_atomic_tensor  # noqa: F401
    import train_materials_tensor  # noqa: F401

    third = sorted(
        {
            m.split(".")[0]
            for m in sys.modules
            if m.split(".")[0] not in sys.stdlib_module_names
            and not m.startswith(("matten_tpu", "train_", "chip_smoke", "_"))
        }
    )
    versions = {}
    for m in third:
        try:
            versions[m] = importlib.metadata.version(m)
        except importlib.metadata.PackageNotFoundError:
            versions[m] = getattr(sys.modules[m], "__version__", "?")
    log(f"third-party modules on the main path: {versions}")
    loaded = [m for m in OFF_PATH if m in sys.modules]
    check(not loaded, f"main path imported {loaded}")
    log(
        "installed here (not imported): "
        + ", ".join(f"{m}={importlib.util.find_spec(m) is not None}" for m in OFF_PATH)
    )
    return {"cache_dir": cache, "cache_entries_before": n_cached}


def flagship(root: Path):
    """The synthetic elasticity set under `root`, its config, and a Trainer
    for the production model with the first training batch — the step that
    `train_materials_tensor.main(config)` compiles. Returns
    (config, trainer, batch)."""
    from matten_tpu.data.datamodule import TensorDataModule
    from matten_tpu.models import create_scalar_tensor_model
    from matten_tpu.train import CanonicalRegressionTask, Trainer
    from matten_tpu.train.config import build_trainer_config

    write_elasticity_set(root / "elasticity.json", N_CRYSTALS, seed=1)
    config = elasticity_config(root)
    dm = TensorDataModule(**config["data"], seed=SEED)
    dm.setup()
    model = create_scalar_tensor_model(dict(config["model"]), dm.get_to_model_info())
    task = CanonicalRegressionTask(
        name="elastic_tensor_full", normalizer=dm.statistics.target_normalizer
    )
    tcfg = dataclasses.replace(build_trainer_config(config), checkpoint_dir=None)
    trainer = Trainer(model, [task], tcfg)
    return config, trainer, next(iter(dm.train_dataloader()))


def phase_train(root: Path) -> dict:
    import jax
    import jax.numpy as jnp

    import train_atomic_tensor
    import train_materials_tensor
    from matten_tpu.data import keys as K

    dev = jax.devices()[0]
    # the production train step on one batch, compiled and timed alone
    t0 = time.perf_counter()
    config, trainer, batch = flagship(root)
    real_edges = int(batch[0][K.EDGE_MASK].sum())
    n_pad, e_pad = batch[0][K.POSITIONS].shape[0], batch[0][K.EDGE_MASK].shape[0]
    state = trainer.init_state(batch, rng_seed=SEED)
    log(f"data and model init: {time.perf_counter() - t0:.1f} s")
    d, t = trainer._to_device(batch)
    t0 = time.perf_counter()
    step = trainer._train_step.lower(state, d, t).compile()
    compile_s = time.perf_counter() - t0
    # the step donates its state: time it on a copy, keep `state` as it was
    holder = {"state": jax.tree.map(jnp.copy, state)}

    def one_step():
        holder["state"], loss, _ = step(holder["state"], d, t)
        return loss

    step_s = timed(one_step, TIMED_STEPS)
    loss = float(one_step())
    check(np.isfinite(loss), f"train loss {loss}")
    peak = peak_bytes(dev)
    log(
        f"train step (production width, batch {BATCH}: {n_pad} padded nodes, "
        f"{e_pad} padded / {real_edges} real edges): compile {compile_s:.2f} s, "
        f"steady {step_s * 1e3:.3f} ms/step, {real_edges / step_s:.0f} edges/s, "
        f"peak memory {peak / 2**30:.3f} GiB, loss {loss:.4f}"
    )

    # the user path: the production script's main()
    t0 = time.perf_counter()
    metrics = train_materials_tensor.main(config)
    fit_s = time.perf_counter() - t0
    log(f"train_materials_tensor.main: {fit_s:.1f} s, test metrics {metrics}")
    check(all(np.isfinite(v) for v in metrics.values()), f"test metrics {metrics}")
    ckpt = root / "ckpt"
    scores = json.loads((ckpt / "index.json").read_text())
    check(bool(scores), "no best checkpoint was recorded")
    check(all(np.isfinite(v) for v in scores.values()), f"val scores {scores}")
    best = min(scores, key=scores.get)
    check((ckpt / f"epoch_{best}" / "state.npz").exists(), "best checkpoint missing")
    check((ckpt / "last" / "state.npz").exists(), "`last` checkpoint missing")

    write_nmr_set(root / "nmr.json", N_NMR, seed=4)
    t0 = time.perf_counter()
    nmr_metrics = train_atomic_tensor.main(nmr_config(root))
    log(
        f"train_atomic_tensor.main: {time.perf_counter() - t0:.1f} s, "
        f"test metrics {nmr_metrics}"
    )
    check(all(np.isfinite(v) for v in nmr_metrics.values()), f"NMR metrics {nmr_metrics}")
    return {
        "ckpt": ckpt,
        "trainer": trainer,
        "state": state,
        "batch": batch,
        "compile_s": compile_s,
        "step_ms": step_s * 1e3,
    }


def phase_predict(root: Path, trained: dict) -> None:
    import jax
    import jax.numpy as jnp

    from matten_tpu.data.dataset import load_tensor_dataset
    from matten_tpu.data.graph import collate_graphs, pad_spec_for
    from matten_tpu.nn.embedding import atomic_number_map
    from matten_tpu.ops.cartesian import cartesian_tensor_map
    from matten_tpu.predict import load_pretrained, predict
    from matten_tpu.train.checkpoint import CheckpointManager

    rng = np.random.default_rng(5)
    sizes = [2, 4, 6, 8, 10, 12, 16, 24][:N_PREDICT]
    structures = [random_structure(rng, n) for n in sizes]
    ckpt = trained["ckpt"]
    # direct apply of the best state restored into the trainer's template,
    # with predict()'s signature
    trainer = trained["trainer"]

    def fwd(variables, data):
        return trainer.model.apply(variables, data, use_running_average=True)

    state = CheckpointManager(ckpt).restore(trained["state"])
    _, _, cfg, statistics, normalize = load_pretrained(ckpt)
    graphs, _ = load_tensor_dataset(None, cfg, structures=structures, dummy_targets=True)
    data, _ = collate_graphs(
        graphs, pad_spec_for(graphs), species_map=atomic_number_map(statistics.allowed_species)
    )
    data = {k: jnp.asarray(v) for k, v in data.items()}
    # host arrays, as predict() passes them
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})

    # at the default precision (TF32), the path users run, and at `highest`
    for precision in ("default", "highest"):
        t0 = time.perf_counter()
        with jax.default_matmul_precision(precision):
            preds = predict(structures, ckpt)
            out = np.asarray(jax.jit(fwd)(variables, data), np.float64)[: len(structures)]
        log(
            f"predict() at {precision}: {len(structures)} structures and the direct "
            f"apply in {time.perf_counter() - t0:.2f} s"
        )
        check(len(preds) == len(structures), "predict() dropped structures")
        for p in preds:
            check(p is not None and np.shape(p) == (3, 3, 3, 3), f"prediction {np.shape(p)}")
            check(bool(np.isfinite(p).all()), "non-finite prediction")
        if normalize:
            out = np.asarray(statistics.target_normalizer.inverse(out))
        direct = np.asarray(cartesian_tensor_map(cfg.tensor_target_formula).to_cartesian(out))
        dev = rel_diff(np.stack(preds), direct)
        log(
            f"predict() vs direct apply of the restored state at {precision}: "
            f"{dev:.3e} of max |value|"
        )
        tol = TOL_PREDICT[precision]
        check(dev <= tol, f"predict() at {precision} deviates {dev:.3e} > {tol:g}")


def phase_numerics(trained: dict) -> dict:
    import jax

    trainer = trained["trainer"]
    model, task = trainer.model, trainer.tasks[0]
    state = trained["state"]
    data, targets = trained["batch"]

    def fwd_grad(params, batch_stats, d, t):
        def loss_fn(p):
            out, _ = model.apply(
                {"params": p, "batch_stats": batch_stats}, d,
                mutable=["batch_stats"], use_running_average=False,
            )
            return trainer._compute_loss({task.name: out}, d, t), out

        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return out, loss, grads

    def run(device, precision):
        t0 = time.perf_counter()
        args = jax.device_put((state.params, state.batch_stats, data, targets), device)
        with jax.default_matmul_precision(precision):
            out = jax.device_get(jax.jit(fwd_grad)(*args))
        log(f"forward + gradient on {device.platform} at {precision}: "
            f"{time.perf_counter() - t0:.1f} s with compilation")
        return out

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    ref = run(cpu, "highest")
    res = {}
    for precision, tol in (("highest", TOL_HIGHEST), ("default", TOL_DEFAULT)):
        got = run(gpu, precision)
        d_out = rel_diff(got[0], ref[0])
        d_grad = rel_diff(got[2], ref[2])
        log(
            f"GPU at {precision} vs CPU at highest: forward {d_out:.3e}, loss "
            f"{abs(float(got[1]) - float(ref[1])) / abs(float(ref[1])):.3e}, "
            f"gradient {d_grad:.3e} (max |diff| / max |CPU|; limit {tol:g})"
        )
        check(max(d_out, d_grad) <= tol, f"{precision}: deviation above {tol:g}")
        res[precision] = max(d_out, d_grad)
    return res


def opt_moment(opt_state, name: str) -> list:
    """The leaves of an optax state's `name` field (`mu`: Adam's first
    moment, after one step (1 - b1) times the gradient)."""
    import jax

    return [
        v
        for p, v in jax.tree_util.tree_leaves_with_path(opt_state)
        if jax.tree_util.keystr(p).endswith("." + name)
    ]


def phase_four() -> None:
    """One production train step per 4-card mesh layout, each against the
    same step on one card."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from matten_tpu.data import keys as K
    from matten_tpu.data.graph import CrystalGraph
    from matten_tpu.nn.embedding import atomic_number_map
    from matten_tpu.train import CanonicalRegressionTask
    from matten_tpu.train.config import build_mesh_spec, build_trainer_config
    from matten_tpu.train.layouts import (
        data_shards,
        layout_batch,
        layout_trainer,
        reference_grads_fn,
        reference_step,
        reference_weights,
    )

    check(len(jax.devices()) >= 4, f"--four needs 4 cards, found {len(jax.devices())}")
    # the programs are lowered in worker threads, which a
    # `with default_matmul_precision` block would not reach
    jax.config.update("jax_default_matmul_precision", "highest")
    rng = np.random.default_rng(6)
    graphs = []
    for _ in range(BATCH):
        g = CrystalGraph.from_structure(
            random_structure(rng, int(rng.integers(ATOMS[0], ATOMS[1] + 1))), r_cut=5.0
        )
        g.y["elastic_tensor_full"] = rng.normal(size=(1, 21))
        graphs.append(g)
    smap = atomic_number_map(SPECIES)
    ds_hparams = {
        "allowed_species": list(SPECIES),
        "average_num_neighbors": float(np.mean(np.concatenate([g.num_neigh for g in graphs]))),
    }
    # the production optimizer: Adam, lr 0.01, weight decay 1e-5
    tcfg = dataclasses.replace(
        build_trainer_config(elasticity_config(REPO)), checkpoint_dir=None
    )
    task = CanonicalRegressionTask(name="elastic_tensor_full")

    single = layout_trainer(ELASTICITY_MODEL, ds_hparams, [task], tcfg)
    full = layout_batch(graphs, smap)
    state0 = jax.device_get(single.init_state(full, rng_seed=SEED))

    def fresh(sharding=None):
        # the step donates its state: every call gets its own copy
        if sharding is None:
            return jax.tree.map(jnp.asarray, state0)
        return jax.device_put(state0, sharding)

    # every program, lowered with the arguments it is then called with
    jobs, shards = {}, {}
    grads_fn = reference_grads_fn(single)
    for n in sorted({layout["data"] for layout in FOUR_LAYOUTS}):
        shards[n] = data_shards(graphs, smap, n)
        d, t = shards[n][0]
        w = reference_weights(single, shards[n])
        jobs[f"one card, {n} data shards"] = (
            grads_fn, (state0.params, state0.batch_stats, d, t, w)
        )
    layouts = []
    for layout in FOUR_LAYOUTS:
        spec = build_mesh_spec({"trainer": {"devices": 4, "mesh": dict(layout)}})
        trainer = layout_trainer(ELASTICITY_MODEL, ds_hparams, [task], tcfg, spec)
        d, t = trainer._to_device(layout_batch(graphs, smap, spec))
        rep = NamedSharding(trainer.mesh, P())
        name = f"mesh data={spec.n_data} graph={spec.n_graph} mode={spec.mode}"
        jobs[name] = (trainer._train_step, (fresh(rep), d, t))
        layouts.append((name, spec, d, t, rep))
    fd, ft = single._to_device(full)
    jobs["one card, global batch"] = (single._train_step, (fresh(), fd, ft))

    def compile_job(job):
        fn, args = job
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        return compiled, time.perf_counter() - t0

    log(f"compiling {len(jobs)} programs at once ({FOUR_XLA_FLAGS})")
    t_compile = time.perf_counter()
    pool = ThreadPoolExecutor(len(jobs))
    futures = {name: pool.submit(compile_job, job) for name, job in jobs.items()}

    def program(name):
        compiled, secs = futures[name].result()
        log(
            f"{name}: compiled in {secs:.1f} s "
            f"({time.perf_counter() - t_compile:.1f} s after the first start)"
        )
        return compiled

    refs = {}
    failures = []
    try:
        for name, spec, d, t, rep in layouts:
            if spec.n_data not in refs:
                compiled = program(f"one card, {spec.n_data} data shards")
                refs[spec.n_data] = reference_step(
                    single, fresh(), shards[spec.n_data], grads_fn=compiled
                )
            ref, ref_loss = refs[spec.n_data]
            step = program(name)
            new, loss, _ = step(fresh(rep), d, t)
            dev = {
                "loss": abs(float(loss) - ref_loss) / abs(ref_loss),
                "gradient": rel_diff(opt_moment(new.opt_state, "mu"), opt_moment(ref.opt_state, "mu")),
                "batch_stats": rel_diff(new.batch_stats, ref.batch_stats),
                "params": rel_diff(new.params, ref.params),
            }
            holder = {"state": new}

            def one():
                holder["state"], l, _ = step(holder["state"], d, t)
                return l

            step_s = timed(one, 5)
            on = {len(x.sharding.device_set) for x in (d[K.EDGE_INDEX], d[K.POSITIONS])}
            on_out = {len(x.sharding.device_set) for x in jax.tree.leaves(new.params)}
            used = [peak_bytes(x) > 0 for x in jax.devices()[:4]]
            log(
                f"{name}: loss {float(loss):.6f} (one card {ref_loss:.6f}); vs one card "
                + ", ".join(f"{k} {v:.3e}" for k, v in dev.items())
                + f" (limit {TOL_HIGHEST:g}); {step_s * 1e3:.3f} ms/step; inputs on "
                f"{on} devices, state on {on_out}, cards used {used}"
            )
            if max(dev.values()) > TOL_HIGHEST:
                failures.append(f"{name}: deviation above {TOL_HIGHEST:g}")
            if not (on == {4} and on_out == {4} and all(used)):
                failures.append(f"{name}: not spread over 4 cards")

        step = program("one card, global batch")
        holder = {"state": fresh()}

        def one_card():
            holder["state"], l, _ = step(holder["state"], fd, ft)
            return l

        log(f"one card, global batch of {BATCH}: {timed(one_card, 5) * 1e3:.3f} ms/step")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    check(not failures, "; ".join(failures))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four", action="store_true", help="run the 4-card mesh layouts")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    if args.four:
        os.environ["XLA_FLAGS"] = f"{os.environ.get('XLA_FLAGS', '')} {FOUR_XLA_FLAGS}"
    try:
        import jax

        backend = jax.default_backend()
        if backend != "gpu":
            raise RuntimeError(f"no GPU: JAX's default backend is {backend!r}")
        sys.path.insert(0, str(REPO))
        phase_environment()
        if args.four:
            phase_four()
        else:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                trained = phase_train(Path(tmp))
                phase_predict(Path(tmp), trained)
                phase_numerics(trained)
        dev = jax.devices()[0]
        result = {
            "ok": True,
            "device": {
                "platform": dev.platform,
                "kind": dev.device_kind,
                "count": len(jax.devices()),
            },
        }
    except Exception as e:  # every failure ends in one "ok": false line
        traceback.print_exc()
        result = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
