"""Checkpointing: best-k + last train states as .npz files, with sidecars.

Replaces Lightning's ModelCheckpoint / load_from_checkpoint flow
(reference SURVEY.md §5.4): saves params + batch_stats + opt_state, keeps
the top-k checkpoints by `val/score` plus `last`, and stores the model
hparams + dataset statistics sidecar next to the weights so `predict()` can
rebuild the exact model (the analog of save_hyperparameters() +
dataset_statistics.pt, reference model/model.py:66, data/dataset.py:129-142).

Each checkpoint is a directory (`epoch_<n>/`, `last/`) holding one
`state.npz`: the state's leaves as host numpy arrays keyed by their pytree
path (`params/layer0_convnet/conv/w_sc`, `opt_state/0/mu`, ...). Host
arrays carry no device or sharding, so a state saved on one topology
restores on any other.

In a multi-process run every process calls the savers: leaves that span
processes are gathered, the primary process alone writes, and all of them
wait at a barrier until the files are there. Every process reads.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from matten_tpu.parallel.distributed import is_primary_host

__all__ = [
    "CheckpointManager",
    "save_sidecar",
    "load_sidecar",
    "save_state",
    "load_state",
    "load_variables",
]

STATE_FILE = "state.npz"


def _barrier(name: str) -> None:
    """All processes wait here until every one arrives (no-op alone)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


def save_sidecar(directory, hparams: Dict[str, Any], statistics_arrays: Dict[str, np.ndarray]):
    directory = Path(directory)
    if is_primary_host():
        directory.mkdir(parents=True, exist_ok=True)
        with open(directory / "hparams.json", "w") as f:
            json.dump(hparams, f, indent=2, default=str)
        np.savez(directory / "dataset_statistics.npz", **statistics_arrays)
    _barrier(f"sidecar {directory}")


def load_sidecar(directory):
    directory = Path(directory)
    with open(directory / "hparams.json") as f:
        hparams = json.load(f)
    stats_path = directory / "dataset_statistics.npz"
    stats = dict(np.load(stats_path)) if stats_path.exists() else {}
    return hparams, stats


def _key_str(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            raise TypeError(f"unsupported pytree key {k!r}")
    return "/".join(parts)


def _host_array(v) -> np.ndarray:
    """A leaf as one host array, gathered where it spans processes (a
    collective: every process must call it, in the same order)."""
    if isinstance(v, jax.Array) and not v.is_fully_addressable:
        if v.is_fully_replicated:
            return np.asarray(v.addressable_data(0))
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(v, tiled=True))
    return np.asarray(v)


def save_state(path, state) -> None:
    """Write `state`'s leaves to `path` (a directory) atomically. Called by
    every process; the primary one writes."""
    path = Path(path)
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    arrays = {_key_str(p): _host_array(v) for p, v in leaves}
    if is_primary_host():
        tmp = path.with_name(path.name + "_tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / STATE_FILE, **arrays)
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)
    _barrier(f"checkpoint {path}")


def load_state(path, template):
    """Read a state saved by `save_state` into the structure, dtypes and
    device placement of `template`."""
    with np.load(Path(path) / STATE_FILE) as f:
        stored = dict(f)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for p, ref in leaves:
        key = _key_str(p)
        if key not in stored:
            raise KeyError(f"checkpoint {path} has no entry {key!r}")
        v = stored[key]
        if v.shape != np.shape(ref):
            raise ValueError(
                f"checkpoint {path}: {key!r} has shape {v.shape}, the template "
                f"{np.shape(ref)}"
            )
        v = v.astype(ref.dtype)
        if isinstance(ref, jax.Array):
            # committed or not as the template was: jit keys its compiled
            # programs on it, so a restored state reuses the template's
            v = jax.device_put(v, ref.sharding) if ref.committed else jnp.asarray(v)
        out.append(v)
    return jax.tree_util.tree_unflatten(treedef, out)


def load_variables(path) -> Dict[str, dict]:
    """The `params` and `batch_stats` trees of a saved state, without a
    template (nested dicts of numpy arrays)."""
    out: Dict[str, dict] = {}
    with np.load(Path(path) / STATE_FILE) as f:
        for key in f.files:
            col, *rest = key.split("/")
            if col not in ("params", "batch_stats") or not rest:
                continue
            node = out.setdefault(col, {})
            for p in rest[:-1]:
                node = node.setdefault(p, {})
            node[rest[-1]] = f[key]
    return out


class CheckpointManager:
    """Best-k (min val/score) + last checkpoints in `directory`."""

    def __init__(self, directory, save_top_k: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.save_top_k = save_top_k
        self._scores: Dict[int, float] = {}
        self._load_index()

    def _index_path(self) -> Path:
        return self.directory / "index.json"

    def _load_index(self):
        if self._index_path().exists():
            with open(self._index_path()) as f:
                raw = json.load(f)
            self._scores = {int(k): float(v) for k, v in raw.items()}

    def _save_index(self):
        if not is_primary_host():
            return
        tmp = self.directory / "index.json.tmp"
        with open(tmp, "w") as f:
            json.dump(self._scores, f)
        os.replace(tmp, self._index_path())

    def _epoch_dir(self, epoch: int) -> Path:
        return self.directory / f"epoch_{epoch}"

    def save(self, epoch: int, state, metrics: Dict[str, float]):
        save_state(self._epoch_dir(epoch), state)
        self._scores[epoch] = float(metrics.get("val/score", float("inf")))
        # prune beyond top-k
        if len(self._scores) > self.save_top_k:
            worst = max(self._scores, key=self._scores.get)
            self._scores.pop(worst)
            wpath = self._epoch_dir(worst)
            if is_primary_host() and wpath.exists():
                shutil.rmtree(wpath)
        self._save_index()

    def save_last(self, state, loop_state: Optional[Dict[str, Any]] = None):
        """Save the rolling `last` checkpoint (+ training-loop state).

        Called every `save_last_every_epochs` epochs (reference
        ModelCheckpoint save_last=True semantics at 1): a crash resumes from
        the latest save with the optimizer, LR-scheduler and early-stopping
        positions intact.
        """
        save_state(self.directory / "last", state)
        if loop_state is not None and is_primary_host():
            # atomic write: a crash mid-write must not leave corrupt JSON
            # (resume would die on json.load)
            ltmp = self.directory / "loop_state.json.tmp"
            with open(ltmp, "w") as f:
                json.dump(loop_state, f)
            os.replace(ltmp, self.directory / "loop_state.json")

    def load_loop_state(self) -> Optional[Dict[str, Any]]:
        p = self.directory / "loop_state.json"
        if not p.exists():
            return None
        try:
            with open(p) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            # corrupt sidecar (crash between `last` rename and the loop-state
            # write): fall back to state-only resume
            return None

    def has_last(self) -> bool:
        return (self.directory / "last").exists()

    @property
    def best_epoch(self) -> Optional[int]:
        if not self._scores:
            return None
        return min(self._scores, key=self._scores.get)

    def best_path(self) -> Path:
        """The best epoch's checkpoint, else `last`."""
        if self.best_epoch is not None:
            return self._epoch_dir(self.best_epoch)
        return self.directory / "last"

    def restore(self, target, epoch: Optional[int] = None, last: bool = False):
        """Restore into the structure of `target` (a template TrainState)."""
        if last:
            path = self.directory / "last"
        else:
            epoch = epoch if epoch is not None else self.best_epoch
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
            path = self._epoch_dir(epoch)
        return load_state(path, target)
