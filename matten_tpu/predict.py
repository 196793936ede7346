"""Inference API: structures -> predicted tensors from a saved checkpoint.

Reference: matten predict (predict.py:151-264) — resolve the trained
checkpoint + its archived config, rebuild the exact data pipeline and model,
check species support, run batched no-grad evaluation, invert normalization,
convert irreps to Cartesian, and return per-structure tensors with None for
failed conversions.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from matten_tpu.data.dataset import (
    DatasetStatistics,
    TensorDatasetConfig,
    load_tensor_dataset,
)
from matten_tpu.data.graph import collate_graphs, pad_spec_for
from matten_tpu.data.structure import Structure
from matten_tpu.data.transform import MeanNormNormalize
from matten_tpu.models import create_atomic_tensor_model, create_scalar_tensor_model
from matten_tpu.nn.embedding import atomic_number_map
from matten_tpu.ops.cartesian import cartesian_tensor_map
from matten_tpu.ops.elasticity import ElasticTensor
from matten_tpu.train.checkpoint import CheckpointManager, load_sidecar, load_variables

logger = logging.getLogger(__name__)

__all__ = ["predict", "load_pretrained"]


def check_species(structures: Sequence[Structure], allowed_species) -> None:
    """Fail fast if a structure contains unsupported species
    (reference predict.py:96-114)."""
    allowed = set(int(z) for z in allowed_species)
    for i, s in enumerate(structures):
        bad = set(int(z) for z in s.atomic_numbers) - allowed
        if bad:
            raise ValueError(
                f"structure {i} contains species (Z={sorted(bad)}) the model was "
                f"not trained on; supported: {sorted(allowed)}"
            )


def load_pretrained(checkpoint_dir: Union[str, Path]):
    """Rebuild (model, params/batch_stats variables, cfg, statistics)."""
    checkpoint_dir = Path(checkpoint_dir)
    hparams, stats_arrays = load_sidecar(checkpoint_dir)
    data_hp = hparams["data"]
    cfg = TensorDatasetConfig(
        r_cut=data_hp.get("r_cut", 5.0),
        tensor_target_name=data_hp.get("tensor_target_name", "elastic_tensor_full"),
        tensor_target_format=data_hp.get("tensor_target_format", "irreps"),
        tensor_target_formula=data_hp.get("tensor_target_formula", "ijkl=jikl=klij"),
        atom_selector=data_hp.get("atom_selector"),
    )
    statistics = DatasetStatistics.from_arrays(stats_arrays, cfg)
    dataset_hparams = hparams["dataset_hparams"]
    if cfg.per_atom:
        model = create_atomic_tensor_model(hparams["model"], dataset_hparams)
    else:
        model = create_scalar_tensor_model(hparams["model"], dataset_hparams)

    # prefer the best epoch (from the manager index), fall back to `last`
    variables = load_variables(CheckpointManager(checkpoint_dir).best_path())
    normalize = bool(hparams.get("normalize_tensor_target", False))
    return model, variables, cfg, statistics, normalize


def predict(
    structures: Union[Structure, dict, Sequence[Union[Structure, dict]]],
    checkpoint_dir: Union[str, Path],
    batch_size: int = 32,
) -> Union[Optional[np.ndarray], List[Optional[np.ndarray]]]:
    """Predict the target tensor(s) for one or more structures.

    Structures may be `Structure` objects or pymatgen Structure dicts.
    Returns Cartesian tensors (e.g. [3,3,3,3] elasticity in the training
    units) — per structure for graph-level models, or [N_atoms, 3, 3] for
    per-atom models; None marks structures that failed graph conversion.
    """
    single = not isinstance(structures, (list, tuple))
    if single:
        structures = [structures]
    structures = [
        s if isinstance(s, Structure) else Structure.from_dict(s) for s in structures
    ]

    model, variables, cfg, statistics, normalize = load_pretrained(checkpoint_dir)
    check_species(structures, statistics.allowed_species)
    graphs, failed = load_tensor_dataset(
        None, cfg, structures=structures, dummy_targets=True
    )
    species_map = atomic_number_map(statistics.allowed_species)
    cmap = cartesian_tensor_map(cfg.tensor_target_formula)
    normalizer = statistics.target_normalizer if normalize else None

    # the variables are an argument, not constants baked into the program:
    # the compiled forward then depends only on the model and the pad shape
    @jax.jit
    def fwd(variables, data):
        return model.apply(variables, data, use_running_average=True)

    results: List[Optional[np.ndarray]] = []
    for i in range(0, len(graphs), batch_size):
        chunk = graphs[i : i + batch_size]
        pad = pad_spec_for(chunk)
        data, _ = collate_graphs(chunk, pad, species_map=species_map)
        data = {k: jnp.asarray(v) for k, v in data.items()}
        out = np.asarray(fwd(variables, data))
        if cfg.per_atom:
            node_off = 0
            for g in chunk:
                v = out[node_off : node_off + g.num_nodes].astype(np.float64)
                if normalizer is not None:
                    v = np.asarray(normalizer.inverse(v))
                results.append(np.asarray(cmap.to_cartesian(v)))
                node_off += g.num_nodes
        else:
            for j in range(len(chunk)):
                v = out[j].astype(np.float64)
                if normalizer is not None:
                    v = np.asarray(normalizer.inverse(v))
                cart = np.asarray(cmap.to_cartesian(v))
                if cart.shape == (3, 3, 3, 3):
                    # structured elasticity output: ndarray subclass adding
                    # .voigt / VRH moduli (reference predict.py:217-218
                    # wraps in pymatgen ElasticTensor; ours is own-built,
                    # with .to_pymatgen() when pymatgen is importable)
                    cart = ElasticTensor(cart)
                results.append(cart)

    # reinsert None for failed rows (reference predict.py:217-240)
    final: List[Optional[np.ndarray]] = []
    it = iter(results)
    failed_set = set(failed)
    for i in range(len(structures)):
        final.append(None if i in failed_set else next(it))
    if failed:
        logger.warning("%d structures failed conversion -> None", len(failed))
    return final[0] if single else final
