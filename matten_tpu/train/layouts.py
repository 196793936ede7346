"""One train step under a device-mesh layout, and the same step on one device.

A training config chooses its layout with `trainer.devices` / `trainer.mesh`
(`train.config.build_mesh_spec`): `data` shards split each batch's graphs
(gradients and batch-norm running statistics are averaged over them), and
`graph` shards split each data shard's edges (`edge`) or nodes (`node`,
`node_ring`). `layout_trainer` and `layout_batch` build the trainer and the
batch layout that `scripts/train_materials_tensor.main` builds for a layout;
`__graft_entry__.dryrun_multichip` and `chip_smoke.py --four` step them.

`reference_step` is a layout's step on one device. Each data shard's
sub-batch runs the plain model, so batch-norm statistics are per data shard
as under the mesh (synced over its graph shards), the loss is the masked
mean over all shards, and the running statistics are the shards' mean.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from matten_tpu.data.datamodule import BatchLoader
from matten_tpu.models import create_scalar_tensor_model
from matten_tpu.train.config import MeshSpec
from matten_tpu.train.task import masked_mse_sums
from matten_tpu.train.trainer import Trainer, TrainerConfig, TrainState

__all__ = [
    "layout_trainer",
    "layout_batch",
    "data_shards",
    "reference_grads_fn",
    "reference_step",
]

Batch = Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]


def layout_trainer(
    model_hparams: Dict,
    dataset_hparams: Dict,
    tasks: List,
    config: TrainerConfig,
    spec: Optional[MeshSpec] = None,
) -> Trainer:
    """A graph-level tensor model's trainer for `spec` (None: one device)."""
    hparams = dict(model_hparams)
    mesh, mode = None, "edge"
    if spec is not None:
        mesh, mode = spec.make_mesh(), spec.mode
        if spec.n_graph > 1:
            hparams.update(graph_parallel_axis="graph", graph_parallel_mode=spec.mode)
    model = create_scalar_tensor_model(hparams, dataset_hparams)
    return Trainer(model, tasks, config, mesh=mesh, graph_shard_mode=mode)


def layout_batch(
    graphs: Sequence, species_map: np.ndarray, spec: Optional[MeshSpec] = None, **loader_kwargs
) -> Batch:
    """All of `graphs` as one batch, in `spec`'s sharded form."""
    if spec is not None:
        loader_kwargs.update(spec.loader_kwargs())
    loader = BatchLoader(
        list(graphs), batch_size=len(graphs), species_map=species_map, **loader_kwargs
    )
    return next(iter(loader))


def data_shards(
    graphs: Sequence, species_map: np.ndarray, n_data: int, **loader_kwargs
) -> List[Batch]:
    """The one-device sub-batch of each of `n_data` data shards: the graphs
    a layout gives each shard, all padded to one shape."""
    if n_data == 1:
        return [layout_batch(graphs, species_map, **loader_kwargs)]
    data, targets = layout_batch(graphs, species_map, MeshSpec(n_data=n_data), **loader_kwargs)
    return [
        ({k: v[s] for k, v in data.items()}, {k: v[s] for k, v in targets.items()})
        for s in range(n_data)
    ]


def _task_sums(trainer: Trainer, preds: Dict, data: Dict, targets: Dict):
    """Per task: (sum of squared errors, element count) as the trainer's
    loss counts them."""
    out = []
    for task in trainer.tasks:
        mask = trainer._task_mask(task, data, targets)
        sw = None
        if not task.per_atom and "target_weight" in data:
            sw = data["target_weight"][:, 0]
        out.append(masked_mse_sums(preds[task.name], targets[task.name], mask, sw))
    return out


def reference_grads_fn(trainer: Trainer):
    """jit of (params, batch_stats, data, targets, weights) -> (loss part,
    its gradient, batch-norm updates) for one data shard's sub-batch.
    `weights[i]` is task i's loss weight over its element count in the whole
    batch, so that the parts of all shards sum to the batch's loss."""
    model, tasks = trainer.model, trainer.tasks

    def fn(params, batch_stats, data, targets, weights):
        def loss_fn(p):
            variables = {"params": p}
            updates = {}
            if batch_stats:
                variables["batch_stats"] = batch_stats
                out, updates = model.apply(
                    variables, data, mutable=["batch_stats"], use_running_average=False
                )
            else:
                out = model.apply(variables, data, use_running_average=False)
            preds = out if isinstance(out, dict) else {tasks[0].name: out}
            sums = _task_sums(trainer, preds, data, targets)
            return sum(weights[i] * s for i, (s, _) in enumerate(sums)), updates

        (loss, updates), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, grads, updates

    return jax.jit(fn)


def reference_weights(trainer: Trainer, shards: Sequence[Batch]) -> jnp.ndarray:
    """Each task's loss weight over its element count in all `shards`."""
    counts = np.zeros(len(trainer.tasks))
    for d, t in shards:
        counts += [float(c) for _, c in _task_sums(trainer, t, d, t)]
    return jnp.asarray(
        [task.loss_weight / max(c, 1.0) for task, c in zip(trainer.tasks, counts)],
        jnp.float32,
    )


def reference_step(
    trainer: Trainer, state: TrainState, shards: Sequence[Batch], grads_fn=None
) -> Tuple[TrainState, float]:
    """`trainer`'s one-device step over the data shards `shards` with the
    semantics of a mesh step: returns (new state, loss). `grads_fn` is
    `reference_grads_fn(trainer)` or its compiled form."""
    grads_fn = grads_fn or reference_grads_fn(trainer)
    weights = reference_weights(trainer, shards)
    loss, grads, updates = 0.0, None, []
    for d, t in shards:
        part, g, u = grads_fn(state.params, state.batch_stats, d, t, weights)
        loss += float(part)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        updates.append(u)
    updates = jax.tree.map(lambda *us: sum(us) / len(us), *updates)
    return jax.jit(trainer._apply_updates)(state, grads, updates), loss
