"""The training loop: jitted steps, plateau LR, early stopping, checkpoints.

Replacement for the reference's delegation to PyTorch Lightning
(model/model.py:17-480, scripts/train_materials_tensor.py:34-68):

  * jitted train/eval steps (donated state) over padded static-shape batches,
  * Adam + L2 weight decay (torch-Adam semantics: decay added to gradients)
    with a mutable injected learning rate,
  * ReduceLROnPlateau on `val/score` (factor/patience as in the reference
    config, scripts/configs/materials_tensor.yaml:103-115),
  * early stopping + best-k checkpointing on `val/score` (ModelCheckpoint /
    EarlyStopping semantics, configs yaml:78-96),
  * streaming MAE metrics computed on denormalized values,
  * per-epoch wall-time logging (reference TimeMeter, model/utils.py:4-35).

SPMD: when a mesh is provided, batches are sharded over the data axis and
gradients are reduced by XLA collectives inserted from sharding constraints
(jit-of-sharded, replacing Lightning DDP/NCCL).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from matten_tpu.data import keys as K
from matten_tpu.train.task import Task, masked_abs_err_sum, masked_mse

logger = logging.getLogger(__name__)

__all__ = ["TrainerConfig", "Trainer", "TrainState", "ReduceLROnPlateau"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Dict[str, Any]
    batch_stats: Dict[str, Any]
    opt_state: optax.OptState

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def apply_gradients(self, grads, tx):
        updates, new_opt_state = tx.update(grads, self.opt_state, self.params)
        new_params = optax.apply_updates(self.params, updates)
        return self.replace(
            step=self.step + 1, params=new_params, opt_state=new_opt_state
        )


@dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch ReduceLROnPlateau semantics)."""

    factor: float = 0.5
    patience: int = 50
    mode: str = "min"
    min_lr: float = 0.0
    best: float = dc_field(default=float("inf"))
    num_bad: int = 0
    scale: float = 1.0

    def step(self, score: float) -> bool:
        """Returns True if the LR was reduced this step."""
        improved = score < self.best if self.mode == "min" else score > self.best
        if improved:
            self.best = score
            self.num_bad = 0
            return False
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.scale *= self.factor
            self.num_bad = 0
            return True
        return False


@dataclass
class TrainerConfig:
    max_epochs: int = 1000
    lr: float = 0.01
    weight_decay: float = 1e-5
    # "adam" (reference default, configs yaml:103-108; torch-Adam semantics,
    # L2 added to gradients) | "adamw" (decoupled decay) | "sgd" (exact-
    # parity tests: first-step param deltas are lr-scaled gradients, so
    # comparisons are not amplified by Adam's sign(g)*lr normalization)
    optimizer: str = "adam"
    # "plateau" (ReduceLROnPlateau on val/score) | "none" (constant LR;
    # reference lr_scheduler class_path: none, model/model.py:464-480)
    scheduler: str = "plateau"
    lr_factor: float = 0.5
    lr_patience: int = 50
    early_stopping_patience: int = 150
    checkpoint_dir: Optional[str] = None
    save_top_k: int = 3
    log_every_epochs: int = 1
    seed: int = 35
    # dispatch up to this many consecutive same-shape batches as ONE jitted
    # lax.scan of train steps, so the per-dispatch host cost is paid once
    # per K steps (the best K on the GPU is unmeasured). Batch order is
    # preserved (only consecutive batches of identical padded shape are
    # grouped), so resume-replay determinism is unchanged. 1 disables.
    scan_steps: int = 1
    # save the rolling `last` checkpoint every N epochs instead of every
    # epoch (1 = reference ModelCheckpoint save_last semantics). A save
    # copies the whole state to the host; production configs trade
    # crash-recovery granularity (a crash loses < N epochs; resume replay
    # stays exact, it just restarts from the last saved epoch) for fewer
    # of those stalls.
    save_last_every_epochs: int = 1


class Trainer:
    def __init__(
        self,
        model,
        tasks: List[Task],
        config: TrainerConfig,
        mesh=None,
        data_axis: str = "data",
        graph_axis: str = "graph",
        graph_shard_mode: str = "edge",  # "edge" | "node" (see nn.conv)
        metrics_logger=None,  # object with .log(dict, step=) (e.g. WandbLogger)
    ):
        self.model = model
        self.tasks = tasks
        self.config = config
        self.mesh = mesh
        self.data_axis = data_axis
        self.graph_axis = graph_axis
        self.graph_shard_mode = graph_shard_mode
        self.metrics_logger = metrics_logger
        self.tx = optax.inject_hyperparams(
            functools.partial(self._make_tx, kind=config.optimizer)
        )(learning_rate=config.lr, weight_decay=config.weight_decay)
        self.scheduler = (
            ReduceLROnPlateau(factor=config.lr_factor, patience=config.lr_patience)
            if getattr(config, "scheduler", "plateau") != "none"
            else None
        )
        self.history: List[Dict[str, float]] = []
        self._step_cache: Dict = {}
        # scan_steps multi-step dispatch is available on EVERY path (single
        # device, data-parallel mesh, graph-sharded mesh)
        self._train_scan = None
        self._eval_scan = None
        scan = config.scan_steps > 1
        if mesh is not None and dict(mesh.shape).get(graph_axis, 1) > 1:
            # combined data x edge-partition SPMD; steps built lazily per
            # batch key-set (field names determine the sharding specs)
            self._train_step = self._spmd_dispatch("train")
            self._eval_step = self._spmd_dispatch("eval")
            if scan:
                self._train_scan = self._spmd_dispatch("train_scan")
                self._eval_scan = self._spmd_dispatch("eval_scan")
        elif mesh is not None:
            from jax.sharding import PartitionSpec as P

            rep, sh = P(), P(self.data_axis)
            sh2 = P(None, self.data_axis)  # [K, S, ...] scan stacks
            self._train_step = jax.jit(
                jax.shard_map(
                    self._dp_train_step_impl,
                    mesh=mesh,
                    in_specs=(rep, sh, sh),
                    out_specs=(rep, rep, rep),
                    check_vma=False,
                ),
                donate_argnums=(0,),
            )
            self._eval_step = jax.jit(
                jax.shard_map(
                    self._dp_eval_step_impl,
                    mesh=mesh,
                    in_specs=(rep, sh, sh),
                    out_specs=(rep, rep),
                    check_vma=False,
                )
            )
            if scan:
                self._train_scan = jax.jit(
                    jax.shard_map(
                        self._dp_train_scan_impl,
                        mesh=mesh,
                        in_specs=(rep, sh2, sh2),
                        out_specs=(rep, rep),
                        check_vma=False,
                    ),
                    donate_argnums=(0,),
                )
                self._eval_scan = jax.jit(
                    jax.shard_map(
                        self._dp_eval_scan_impl,
                        mesh=mesh,
                        in_specs=(rep, sh2, sh2),
                        out_specs=(rep, rep),
                        check_vma=False,
                    )
                )
        else:
            self._train_step = jax.jit(self._train_step_impl, donate_argnums=(0,))
            self._eval_step = jax.jit(self._eval_step_impl)
            if scan:
                self._train_scan = jax.jit(
                    self._train_scan_impl, donate_argnums=(0,)
                )
                self._eval_scan = jax.jit(self._eval_scan_impl)
        self._ckpt_manager = None
        if config.checkpoint_dir is not None:
            from matten_tpu.train.checkpoint import CheckpointManager

            self._ckpt_manager = CheckpointManager(
                config.checkpoint_dir, save_top_k=config.save_top_k
            )

    @staticmethod
    def _make_tx(learning_rate, weight_decay, kind="adam"):
        # optax.flatten runs the update over ONE concatenated vector instead
        # of one fusion per param leaf (~160 leaves of tiny elementwise
        # kernels per step; flattened it is a handful of wide ops).
        # Semantics are identical for elementwise optimizers.
        if kind == "adamw":
            # torch-AdamW semantics: decoupled weight decay
            return optax.flatten(optax.adamw(learning_rate, weight_decay=weight_decay))
        # torch-Adam/SGD semantics: L2 decay added to gradients before update
        opt = {"adam": optax.adam, "sgd": optax.sgd}[kind]
        return optax.flatten(
            optax.chain(
                optax.add_decayed_weights(weight_decay),
                opt(learning_rate),
            )
        )

    # ------------------------------------------------------------------
    def init_state(self, sample_batch: Tuple[Dict, Dict], rng_seed: int = 0) -> TrainState:
        data = {k: jnp.asarray(v) for k, v in sample_batch[0].items()}
        if self.mesh is not None and np.asarray(data[K.POSITIONS]).ndim >= 3:
            # sharded-loader batch ([S, ...] stacked, graph-sharded fields
            # [S, Sg, ...]): init traces on shard (0, 0)'s local view —
            # parameter shapes are independent of node/edge counts
            gax = dict(self.mesh.shape).get(self.graph_axis, 1)
            sharded = set(self._graph_sharded_fields())
            data = {
                k: (v[0, 0] if gax > 1 and k in sharded else v[0])
                for k, v in data.items()
            }
        # jitted: run eagerly, init would dispatch (and compile) every op
        # of the forward pass on its own
        variables = jax.jit(self.model.init)(jax.random.PRNGKey(rng_seed), data)
        params = variables["params"]
        batch_stats = variables.get("batch_stats", {})
        nparams = sum(x.size for x in jax.tree.leaves(params))
        logger.info("model initialized: %d parameters", nparams)
        return TrainState(
            step=jnp.zeros((), dtype=jnp.int32),
            params=params,
            batch_stats=batch_stats,
            opt_state=jax.jit(self.tx.init)(params),
        )

    # ------------------------------------------------------------------
    def _task_mask(self, task: Task, data: Dict, targets: Dict):
        if task.per_atom:
            sel = targets.get("atom_selector")
            mask = data[K.NODE_MASK]
            if sel is not None:
                mask = mask & (sel.astype(bool))
            return mask
        return data[K.GRAPH_MASK]

    def _compute_loss(
        self, preds: Dict, data: Dict, targets: Dict, global_mean: bool = False
    ):
        """Weighted multi-task masked MSE.

        global_mean=True (SPMD step): each task's (sum, count) is psum'd
        over the data axis — and the graph axis for node-sharded per-atom
        rows — so the loss is the exact global mean regardless of per-shard
        row counts.
        """
        loss = 0.0
        node_axis = self._node_axis()
        for task in self.tasks:
            mask = self._task_mask(task, data, targets)
            sw = None
            if not task.per_atom and "target_weight" in data:
                sw = data["target_weight"][:, 0]
            axes = []
            if global_mean:
                axes.append(self.data_axis)
                if task.per_atom and node_axis is not None:
                    axes.append(node_axis)
            loss = loss + task.loss_weight * masked_mse(
                preds[task.name],
                targets[task.name],
                mask,
                sw,
                psum_axis=tuple(axes) if axes else None,
            )
        return loss

    def _node_axis(self):
        if (
            self.mesh is not None
            and self.graph_shard_mode in ("node", "node_ring")
            and dict(self.mesh.shape).get(self.graph_axis, 1) > 1
        ):
            return self.graph_axis
        return None

    def _metric_sums(self, preds: Dict, data: Dict, targets: Dict):
        out = {}
        node_axis = self._node_axis()
        for task in self.tasks:
            mask = self._task_mask(task, data, targets)
            p = task.transform_for_metric(preds[task.name])
            t = task.transform_for_metric(targets[task.name])
            s, c = masked_abs_err_sum(p, t, mask)
            if task.per_atom and node_axis is not None:
                s = jax.lax.psum(s, node_axis)
                c = jax.lax.psum(c, node_axis)
            out[task.name] = (s, c)
        return out

    def _grads_and_metrics(
        self, state: TrainState, data: Dict, targets: Dict, global_mean: bool = False
    ):
        """Local (per-shard) gradient + metric computation."""

        def loss_fn(params):
            variables = {"params": params}
            if state.batch_stats:
                variables["batch_stats"] = state.batch_stats
                out, updates = self.model.apply(
                    variables, data, mutable=["batch_stats"], use_running_average=False
                )
            else:
                out = self.model.apply(variables, data, use_running_average=False)
                updates = {}
            preds = out if isinstance(out, dict) else {self.tasks[0].name: out}
            loss = self._compute_loss(preds, data, targets, global_mean=global_mean)
            return loss, (updates, preds)

        (loss, (updates, preds)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        metric_sums = self._metric_sums(preds, data, targets)
        return grads, loss, updates, metric_sums

    def _apply_updates(self, state: TrainState, grads, updates) -> TrainState:
        state = state.apply_gradients(grads, self.tx)
        if updates:
            state = state.replace(
                batch_stats=updates.get("batch_stats", state.batch_stats)
            )
        return state

    def _train_step_impl(self, state: TrainState, data: Dict, targets: Dict):
        grads, loss, updates, metric_sums = self._grads_and_metrics(
            state, data, targets
        )
        state = self._apply_updates(state, grads, updates)
        return state, loss, metric_sums

    def _train_scan_impl(self, state: TrainState, data_stack: Dict, targets_stack: Dict):
        """K sequential train steps in one dispatch (lax.scan over stacked
        batches). Semantically identical to K `_train_step_impl` calls;
        exists to amortize the per-dispatch host cost
        (TrainerConfig.scan_steps). Returns per-step losses [K]."""

        def body(st, dt):
            d, t = dt
            st, loss, _ = self._train_step_impl(st, d, t)
            return st, loss

        state, losses = jax.lax.scan(body, state, (data_stack, targets_stack))
        return state, losses

    def _eval_scan_impl(self, state: TrainState, data_stack: Dict, targets_stack: Dict):
        """K eval steps in one dispatch; returns (loss_sum, summed metric
        (sum, count) pairs) — the accumulation `_run_eval` would do across
        K per-batch dispatches, without K fixed per-dispatch costs."""

        def body(_, dt):
            d, t = dt
            return None, self._eval_step_impl(state, d, t)

        _, (losses, ms) = jax.lax.scan(body, None, (data_stack, targets_stack))
        return jnp.sum(losses), jax.tree.map(lambda x: jnp.sum(x, axis=0), ms)

    def _eval_core(
        self, state: TrainState, data: Dict, targets: Dict, global_mean: bool = False
    ):
        variables = {"params": state.params}
        if state.batch_stats:
            variables["batch_stats"] = state.batch_stats
        preds_out = self.model.apply(variables, data, use_running_average=True)
        preds = (
            {self.tasks[0].name: preds_out}
            if not isinstance(preds_out, dict)
            else preds_out
        )
        loss = self._compute_loss(preds, data, targets, global_mean=global_mean)
        return loss, self._metric_sums(preds, data, targets)

    def _eval_step_impl(self, state: TrainState, data: Dict, targets: Dict):
        return self._eval_core(state, data, targets)

    # ---- SPMD data parallelism (shard_map over the mesh's data axis) -----
    def _dp_train_step_impl(self, state: TrainState, data: Dict, targets: Dict):
        """Per-shard body: data/targets arrive as the local [1, ...] block.

        The loss is the exact global masked mean (per-task (sum, count)
        psums inside `_compute_loss`), so ragged tail shards — whose masks
        are all False — contribute nothing to either the numerator or the
        denominator; the round-1 per-shard-mean pmean deflated loss and
        gradients whenever a tail shard was all-masked (VERDICT weak #7).

        Gradient collective: in this unchecked shard_map, psum transposes
        to psum, so differentiating through the loss psums leaves each
        shard holding S x (its local partial gradient); pmean therefore
        reconstructs exactly psum(partials) — the true global-mean
        gradient. Verified exactly against the single-device step
        (including a ragged all-masked tail shard) in
        tests/parallel/test_dp.py.
        """
        ax = self.data_axis
        data = jax.tree.map(lambda x: x[0], data)
        targets = jax.tree.map(lambda x: x[0], targets)
        grads, loss, updates, ms = self._grads_and_metrics(
            state, data, targets, global_mean=True
        )
        grads = jax.lax.pmean(grads, ax)
        if updates:
            updates = jax.tree.map(lambda x: jax.lax.pmean(x, ax), updates)
        ms = jax.tree.map(lambda x: jax.lax.psum(x, ax), ms)
        state = self._apply_updates(state, grads, updates)
        return state, loss, ms

    def _dp_eval_step_impl(self, state: TrainState, data: Dict, targets: Dict):
        data = jax.tree.map(lambda x: x[0], data)
        targets = jax.tree.map(lambda x: x[0], targets)
        loss, ms = self._eval_core(state, data, targets, global_mean=True)
        ms = jax.tree.map(lambda x: jax.lax.psum(x, self.data_axis), ms)
        return loss, ms

    def _dp_train_scan_impl(self, state: TrainState, data_stack: Dict, targets_stack: Dict):
        """scan_steps under the data-parallel mesh: per-shard local blocks
        arrive stacked [K, 1, ...]; lax.scan of the per-step body (psums
        inside) keeps exact step semantics while paying one dispatch."""

        def body(st, dt):
            d, t = dt
            st, loss, _ = self._dp_train_step_impl(st, d, t)
            return st, loss

        return jax.lax.scan(body, state, (data_stack, targets_stack))

    def _dp_eval_scan_impl(self, state: TrainState, data_stack: Dict, targets_stack: Dict):
        def body(_, dt):
            d, t = dt
            return None, self._dp_eval_step_impl(state, d, t)

        _, (losses, ms) = jax.lax.scan(body, None, (data_stack, targets_stack))
        return jnp.sum(losses), jax.tree.map(lambda x: jnp.sum(x, axis=0), ms)

    # ---- combined data x edge-partition SPMD (shard_map, vma-checked) ----
    EDGE_FIELDS = (
        K.EDGE_INDEX,
        K.EDGE_CELL_SHIFT,
        K.EDGE_VECTORS,
        K.EDGE_MASK,
    )
    NODE_FIELDS = (
        K.POSITIONS,
        K.ATOMIC_NUMBERS,
        K.SPECIES_INDEX,
        K.NUM_NEIGH,
        K.BATCH,
        K.NODE_MASK,
        K.ATOM_FEATS,
    )

    def _graph_sharded_fields(self):
        if self.graph_shard_mode in ("node", "node_ring"):
            return self.EDGE_FIELDS + self.NODE_FIELDS
        return self.EDGE_FIELDS

    def _node_sharded_target_keys(self):
        if self.graph_shard_mode not in ("node", "node_ring"):
            return ()
        keys = [t.name for t in self.tasks if t.per_atom]
        if keys:
            keys.append("atom_selector")
        return tuple(keys)

    def _squeeze_mp(self, data: Dict, targets: Dict):
        sharded = self._graph_sharded_fields()
        tsharded = self._node_sharded_target_keys()
        d = {k: (v[0, 0] if k in sharded else v[0]) for k, v in data.items()}
        t = {k: (v[0, 0] if k in tsharded else v[0]) for k, v in targets.items()}
        return d, t

    def _mp_train_step_impl(self, state: TrainState, data: Dict, targets: Dict):
        data, targets = self._squeeze_mp(data, targets)
        dax = self.data_axis

        def loss_fn(params):
            variables = {"params": params}
            if state.batch_stats:
                variables["batch_stats"] = state.batch_stats
                out, updates = self.model.apply(
                    variables, data, mutable=["batch_stats"], use_running_average=False
                )
            else:
                out = self.model.apply(variables, data, use_running_average=False)
                updates = {}
            preds = out if isinstance(out, dict) else {self.tasks[0].name: out}
            # the global (sum, count) mean is differentiated THROUGH its
            # cross-shard psums so the vma machinery emits the correct
            # (replicated) parameter gradients
            loss = self._compute_loss(preds, data, targets, global_mean=True)
            return loss, (updates, preds)

        (loss, (updates, preds)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        if updates:
            updates = jax.tree.map(lambda x: jax.lax.pmean(x, dax), updates)
        ms = jax.tree.map(
            lambda x: jax.lax.psum(x, dax), self._metric_sums(preds, data, targets)
        )
        state = self._apply_updates(state, grads, updates)
        return state, loss, ms

    def _mp_eval_step_impl(self, state: TrainState, data: Dict, targets: Dict):
        data, targets = self._squeeze_mp(data, targets)
        variables = {"params": state.params}
        if state.batch_stats:
            variables["batch_stats"] = state.batch_stats
        preds_out = self.model.apply(variables, data, use_running_average=True)
        preds = (
            {self.tasks[0].name: preds_out}
            if not isinstance(preds_out, dict)
            else preds_out
        )
        loss = self._compute_loss(preds, data, targets, global_mean=True)
        ms = jax.tree.map(
            lambda x: jax.lax.psum(x, self.data_axis),
            self._metric_sums(preds, data, targets),
        )
        return loss, ms

    def _mp_train_scan_impl(self, state: TrainState, data_stack: Dict, targets_stack: Dict):
        """scan_steps under a graph-sharded mesh (local blocks [K, 1, 1, ...])."""

        def body(st, dt):
            d, t = dt
            st, loss, _ = self._mp_train_step_impl(st, d, t)
            return st, loss

        return jax.lax.scan(body, state, (data_stack, targets_stack))

    def _mp_eval_scan_impl(self, state: TrainState, data_stack: Dict, targets_stack: Dict):
        def body(_, dt):
            d, t = dt
            return None, self._mp_eval_step_impl(state, d, t)

        _, (losses, ms) = jax.lax.scan(body, None, (data_stack, targets_stack))
        return jnp.sum(losses), jax.tree.map(lambda x: jnp.sum(x, axis=0), ms)

    def _spmd_dispatch(self, kind: str):
        from jax.sharding import PartitionSpec as P

        scan = kind.endswith("_scan")

        def jitted(data, targets):
            key = (kind, tuple(sorted(data)), tuple(sorted(targets)))
            if key not in self._step_cache:
                dax, gax = self.data_axis, self.graph_axis
                sharded = self._graph_sharded_fields()
                tsharded = self._node_sharded_target_keys()
                lead = (None,) if scan else ()

                def spec(k, sset):
                    dims = (dax, gax) if k in sset else (dax,)
                    return P(*(lead + dims))

                dspec = {k: spec(k, sharded) for k in data}
                tspec = {k: spec(k, tsharded) for k in targets}
                rep = P()
                impl, out, donate = {
                    "train": (self._mp_train_step_impl, (rep, rep, rep), (0,)),
                    "eval": (self._mp_eval_step_impl, (rep, rep), ()),
                    "train_scan": (self._mp_train_scan_impl, (rep, rep), (0,)),
                    "eval_scan": (self._mp_eval_scan_impl, (rep, rep), ()),
                }[kind]
                fn = jax.jit(
                    jax.shard_map(
                        impl,
                        mesh=self.mesh,
                        in_specs=(rep, dspec, tspec),
                        out_specs=out,
                    ),
                    donate_argnums=donate,
                )
                self._step_cache[key] = fn
            return self._step_cache[key]

        def step(state, data, targets):
            return jitted(data, targets)(state, data, targets)

        # ahead-of-time lowering, as on the jax.jit steps of the other paths
        step.lower = lambda state, data, targets: jitted(data, targets).lower(
            state, data, targets
        )
        return step

    # ------------------------------------------------------------------
    def _set_lr(self, state: TrainState, lr: float) -> TrainState:
        opt_state = state.opt_state
        hp = dict(opt_state.hyperparams)
        hp["learning_rate"] = jnp.asarray(lr, dtype=jnp.float32)
        opt_state = opt_state._replace(hyperparams=hp)
        return state.replace(opt_state=opt_state)

    def _to_device(self, batch, scan: bool = False):
        data, targets = batch
        data = {k: jnp.asarray(v) for k, v in data.items()}
        targets = {k: jnp.asarray(v) for k, v in targets.items()}
        if self.mesh is not None:
            from matten_tpu.parallel.sharding import shard_batch

            data, targets = shard_batch(
                self.mesh, self.data_axis, data, targets, scan=scan
            )
        return data, targets

    def _run_eval(self, state: TrainState, loader) -> Dict[str, float]:
        # accumulate device-side and read everything back in ONE packed
        # fetch at the end: each float() waits for the device
        n = 0
        loss_sum = None
        # pre-seed every task so the packing below can't KeyError if a step's
        # metric dict ever omits one (zero count -> mae 0 as before)
        sums: Dict[str, list] = {
            t.name: [jnp.zeros(()), jnp.zeros(())] for t in self.tasks
        }

        def _accum(loss, ms):
            nonlocal loss_sum
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for name, (s, c) in ms.items():
                sums[name][0] = sums[name][0] + s
                sums[name][1] = sums[name][1] + c

        # group consecutive same-shape batches into one scanned dispatch
        # (exactly scan_k, so at most 2 programs per bucket shape compile);
        # partial groups fall back to per-batch dispatches
        scan_k = self.config.scan_steps if self._eval_scan is not None else 1
        buf, buf_key = [], None

        def _flush(buf):
            if len(buf) == scan_k and scan_k > 1:
                stacked = (
                    {k: np.stack([b[0][k] for b in buf]) for k in buf[0][0]},
                    {k: np.stack([b[1][k] for b in buf]) for k in buf[0][1]},
                )
                d, t = self._to_device(stacked, scan=True)
                _accum(*self._eval_scan(state, d, t))
            else:
                for b in buf:
                    d, t = self._to_device(b)
                    _accum(*self._eval_step(state, d, t))
            buf.clear()

        for batch in loader:
            n += 1
            if scan_k <= 1:
                data, targets = self._to_device(batch)
                _accum(*self._eval_step(state, data, targets))
                continue
            key = tuple(
                sorted((k, np.shape(v)) for k, v in batch[0].items())
            ) + tuple(sorted((k, np.shape(v)) for k, v in batch[1].items()))
            if buf and key != buf_key:
                _flush(buf)
            buf_key = key
            buf.append(batch)
            if len(buf) == scan_k:
                _flush(buf)
        _flush(buf)
        if n == 0:
            # inf, not 0.0: under min-monitored checkpointing a degenerate
            # (empty) val loader must never become the "best" checkpoint
            return {"loss": float("nan"), "score": float("inf")}
        packed = np.asarray(
            jnp.stack(
                [loss_sum]
                + [jnp.asarray(x, jnp.float32) for t in self.tasks for x in sums[t.name]]
            )
        )
        out = {"loss": float(packed[0]) / n}
        score = 0.0
        for i, t in enumerate(self.tasks):
            mae = float(packed[1 + 2 * i]) / max(float(packed[2 + 2 * i]), 1.0)
            out[f"mae/{t.name}"] = mae
            score += t.metric_weight * mae
        out["score"] = score
        return out

    def restore_last(self, template: TrainState) -> TrainState:
        """Resume from the `last` checkpoint (reference `restore: true`
        semantics, SURVEY.md §5.3)."""
        assert self._ckpt_manager is not None, "no checkpoint_dir configured"
        return self._ckpt_manager.restore(template, last=True)

    def restore_best(self, template: TrainState) -> TrainState:
        """Restore the best-val/score checkpoint (the reference's
        trainer.test(ckpt_path="best"), scripts/train_materials_tensor.py:65)."""
        assert self._ckpt_manager is not None, "no checkpoint_dir configured"
        return self._ckpt_manager.restore(template)

    def has_best(self) -> bool:
        return (
            self._ckpt_manager is not None
            and self._ckpt_manager.best_epoch is not None
        )

    def _loop_state(self, epoch, best_score, best_epoch, epochs_no_improve):
        return {
            "epoch": epoch,
            "best_score": best_score,
            "best_epoch": best_epoch,
            "epochs_no_improve": epochs_no_improve,
            "scheduler": (
                {
                    "best": self.scheduler.best,
                    "num_bad": self.scheduler.num_bad,
                    "scale": self.scheduler.scale,
                }
                if self.scheduler is not None
                else None
            ),
        }

    def fit(
        self,
        state: TrainState,
        datamodule,
        start_epoch: int = 0,
        resume: bool = False,
    ) -> TrainState:
        """Train until max_epochs / early stop.

        `resume=True` (reference `restore: true`, config_final.yaml:48)
        continues from the `last` checkpoint: model/optimizer state,
        LR-scheduler position, early-stopping counters and the epoch index
        are all restored, so a killed run reproduces the uninterrupted
        run's schedule exactly (tests/train/test_harness.py).
        """
        cfg = self.config
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()

        best_score = float("inf")
        best_epoch = -1
        epochs_no_improve = 0
        t_start = time.time()

        if resume and self._ckpt_manager is not None and self._ckpt_manager.has_last():
            state = self._ckpt_manager.restore(state, last=True)
            loop = self._ckpt_manager.load_loop_state()
            if loop is not None:
                start_epoch = int(loop["epoch"]) + 1
                best_score = float(loop["best_score"])
                best_epoch = int(loop["best_epoch"])
                epochs_no_improve = int(loop["epochs_no_improve"])
                sch = loop.get("scheduler")
                if self.scheduler is not None and sch is not None:
                    self.scheduler.best = float(sch["best"])
                    self.scheduler.num_bad = int(sch["num_bad"])
                    self.scheduler.scale = float(sch["scale"])
                    state = self._set_lr(state, cfg.lr * self.scheduler.scale)
            logger.info("resumed from `last` at epoch %d", start_epoch)

        for epoch in range(start_epoch, cfg.max_epochs):
            t0 = time.time()
            # per-epoch shuffle reseed: epoch k draws the same batch order
            # whether or not training was interrupted before it
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            # losses stay device-side until epoch end: a float() readback
            # waits for the device, so one readback per epoch instead of one
            # per step
            train_losses = []
            epoch_edges = 0
            scan_k = self.config.scan_steps if self._train_scan is not None else 1
            buf, buf_key = [], None

            def _flush(state, buf):
                # remainder (or scan disabled): plain per-step dispatches
                for b in buf:
                    d, t = self._to_device(b)
                    state, loss, _ = self._train_step(state, d, t)
                    train_losses.append(jnp.reshape(loss, (1,)))
                buf.clear()
                return state

            for batch in train_loader:
                epoch_edges += int(np.asarray(batch[0][K.EDGE_MASK]).sum())
                if scan_k <= 1:
                    data, targets = self._to_device(batch)
                    state, loss, _ = self._train_step(state, data, targets)
                    train_losses.append(jnp.reshape(loss, (1,)))
                    continue
                # group CONSECUTIVE batches of identical padded shape into
                # one scanned dispatch (batch order preserved; a shape
                # change flushes the buffer as single steps). Stacking is
                # host-side so the scan is ONE device dispatch + transfer.
                key = tuple(
                    sorted((k, np.shape(v)) for k, v in batch[0].items())
                ) + tuple(sorted((k, np.shape(v)) for k, v in batch[1].items()))
                if buf and key != buf_key:
                    state = _flush(state, buf)
                buf_key = key
                buf.append(batch)
                if len(buf) == scan_k:
                    stacked = (
                        {k: np.stack([b[0][k] for b in buf]) for k in buf[0][0]},
                        {k: np.stack([b[1][k] for b in buf]) for k in buf[0][1]},
                    )
                    buf.clear()
                    dstack, tstack = self._to_device(stacked, scan=True)
                    state, losses = self._train_scan(state, dstack, tstack)
                    train_losses.append(losses)
            state = _flush(state, buf)

            val_metrics = self._run_eval(state, val_loader)
            score = val_metrics["score"]

            # plateau scheduler + early stopping on val/score
            if self.scheduler is not None and self.scheduler.step(score):
                new_lr = cfg.lr * self.scheduler.scale
                logger.info("epoch %d: reducing lr to %g", epoch, new_lr)
                state = self._set_lr(state, new_lr)

            if score < best_score:
                best_score = score
                best_epoch = epoch
                epochs_no_improve = 0
                if self._ckpt_manager is not None:
                    self._ckpt_manager.save(
                        epoch, state, metrics={"val/score": score}
                    )
            else:
                epochs_no_improve += 1

            epoch_time = time.time() - t0
            rec = {
                "epoch": epoch,
                "train/loss": float(jnp.mean(jnp.concatenate(train_losses)))
                if train_losses
                else float("nan"),
                "val/loss": val_metrics["loss"],
                "val/score": score,
                "lr_scale": self.scheduler.scale if self.scheduler else 1.0,
                "epoch_time": epoch_time,
                "cumulative_time": time.time() - t_start,
                "train/edges_per_s": epoch_edges / max(epoch_time, 1e-9),
            }
            rec.update({f"val/{k}": v for k, v in val_metrics.items() if k.startswith("mae")})
            self.history.append(rec)
            if self.metrics_logger is not None:
                self.metrics_logger.log(rec, step=epoch)
            if epoch % cfg.log_every_epochs == 0:
                logger.info(
                    "epoch %d: train loss %.5f | val score %.5f | %.2fs",
                    epoch,
                    rec["train/loss"],
                    score,
                    epoch_time,
                )
            stop = epochs_no_improve > cfg.early_stopping_patience
            if self._ckpt_manager is not None and (
                stop
                or epoch == cfg.max_epochs - 1
                or (epoch + 1) % max(cfg.save_last_every_epochs, 1) == 0
            ):
                # rolling `last` + loop state (every save_last_every_epochs
                # epochs, and always at the final/stopping epoch): crash
                # recovery loses at most save_last_every_epochs-1 epochs
                # (reference save_last semantics at the default of 1)
                self._ckpt_manager.save_last(
                    state,
                    self._loop_state(epoch, best_score, best_epoch, epochs_no_improve),
                )
            if stop:
                logger.info(
                    "early stopping at epoch %d (best %.5f @ %d)",
                    epoch,
                    best_score,
                    best_epoch,
                )
                break
        return state

    def test(self, state: TrainState, datamodule) -> Dict[str, float]:
        return self._run_eval(state, datamodule.test_dataloader())
