"""Tensor datasets: pandas-JSON of structures + tensorial targets -> graphs.

Input contract preserved from the reference (dataset/
structure_scalar_tensor.py:19-375, notebooks/prepare_data.ipynb): a
pandas-style JSON table (read with the standard `json` module) with a
`structure` column of pymatgen Structure dicts and target columns — a
rank-k Cartesian tensor per crystal (e.g. `elastic_tensor_full`, 3x3x3x3)
or per selected atom (e.g. `nmr_tensor`, [num_selected, 3, 3] + an
`atom_selector` boolean column), plus optional scalar targets.

Per-atom targets are scattered into dense per-node arrays at conversion
time (the static-shape analog of the reference's boolean-mask gather at loss
time, model/model.py:342-345). Failed rows are recorded and skipped
(reference behavior, structure_scalar_tensor.py:357-374).
"""

from __future__ import annotations

import json
import logging
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from matten_tpu.data.graph import CrystalGraph
from matten_tpu.data.structure import Structure
from matten_tpu.data.transform import MeanNormNormalize, ScalarNormalize
from matten_tpu.ops.cartesian import cartesian_tensor_map

logger = logging.getLogger(__name__)

__all__ = ["TensorDatasetConfig", "load_tensor_dataset", "DatasetStatistics"]


@dataclass
class TensorDatasetConfig:
    r_cut: float = 5.0
    tensor_target_name: Optional[str] = "elastic_tensor_full"
    tensor_target_format: str = "irreps"  # "irreps" | "cartesian"
    tensor_target_formula: str = "ijkl=jikl=klij"
    tensor_target_scale: float = 1.0
    atom_selector: Optional[str] = None  # column name of per-atom selector
    scalar_target_names: Tuple[str, ...] = ()
    log_scalar_targets: Tuple[bool, ...] = ()
    tensor_target_weight: Optional[Dict[str, Dict[str, float]]] = None
    # precomputed feature columns (reference atom_featurizer/global_featurizer,
    # dataset/structure_scalar_tensor.py:246-254,315-334 — the reference reads
    # them through featurizer objects; here they are data-file columns):
    # each atom-feature column holds an [N_atom, f] (or [N_atom]) array per
    # row; global columns hold one scalar/vector per crystal. Columns are
    # concatenated feature-wise into x["atom_feats"] / x["global_feats"].
    atom_feats_columns: Tuple[str, ...] = ()
    global_feats_columns: Tuple[str, ...] = ()

    @property
    def per_atom(self) -> bool:
        return self.atom_selector is not None

    @property
    def target_irreps(self):
        return cartesian_tensor_map(self.tensor_target_formula).irreps


def _convert_target(cfg: TensorDatasetConfig, t: np.ndarray) -> np.ndarray:
    """Cartesian tensor(s) -> irreps vectors (or flattened cartesian)."""
    cmap = cartesian_tensor_map(cfg.tensor_target_formula)
    t = np.asarray(t, dtype=np.float64)
    if cfg.tensor_target_format == "irreps":
        return np.atleast_2d(np.asarray(cmap.from_cartesian(t)))
    if cfg.tensor_target_format == "cartesian":
        flat = t.reshape((-1,) + cmap.cartesian_shape)
        return flat.reshape(flat.shape[0], -1)
    raise ValueError(cfg.tensor_target_format)


def read_json_rows(filename) -> List[Dict[str, Any]]:
    """Rows of a pandas-style JSON table, as `pandas.read_json` reads it:
    the default `columns` orientation ({column: {row label: value}}) or the
    `records` orientation ([{column: value}, ...])."""
    with open(filename) as f:
        raw = json.load(f)
    if isinstance(raw, list) and all(isinstance(r, dict) for r in raw):
        return [dict(r) for r in raw]
    if isinstance(raw, dict) and all(isinstance(c, dict) for c in raw.values()):
        labels = list(dict.fromkeys(k for col in raw.values() for k in col))
        return [{c: col.get(label) for c, col in raw.items()} for label in labels]
    raise ValueError(
        f"`{filename}` is neither a columns- nor a records-oriented JSON table"
    )


def load_tensor_dataset(
    filename,
    cfg: TensorDatasetConfig,
    structures: Optional[Sequence[Structure]] = None,
    dummy_targets: bool = False,
) -> Tuple[List[CrystalGraph], List[int]]:
    """Read + convert a dataset file (or an explicit structure list).

    Returns (graphs, failed_row_indices).
    """
    if structures is not None:
        rows: List[Dict[str, Any]] = [{"structure": s} for s in structures]
    else:
        rows = read_json_rows(filename)
        if not rows or "structure" not in rows[0]:
            raise ValueError(
                f"Unsupported input data from `{filename}`: needs a `structure` "
                f"column of pymatgen Structure dicts"
            )
        for r in rows:
            r["structure"] = Structure.from_dict(r["structure"])

    graphs: List[CrystalGraph] = []
    failed: List[int] = []
    cmap = cartesian_tensor_map(cfg.tensor_target_formula)
    tdim = cmap.irreps.dim if cfg.tensor_target_format == "irreps" else int(
        np.prod(cmap.cartesian_shape)
    )
    for i, row in enumerate(rows):
        try:
            struct: Structure = row["structure"]
            n = len(struct)
            y: Dict[str, np.ndarray] = {}
            x: Dict[str, np.ndarray] = {}
            if cfg.tensor_target_name:
                if dummy_targets:
                    raw = (
                        np.zeros((1, tdim))
                        if not cfg.per_atom
                        else np.zeros((n, tdim))
                    )
                else:
                    raw = _convert_target(cfg, row[cfg.tensor_target_name])
                    raw = raw * cfg.tensor_target_scale
                if cfg.per_atom:
                    sel = (
                        np.asarray(row[cfg.atom_selector], dtype=bool)
                        if not dummy_targets
                        else np.ones(n, dtype=bool)
                    )
                    assert len(sel) == n, "atom_selector length != num atoms"
                    dense = np.zeros((n, tdim))
                    if not dummy_targets:
                        assert raw.shape[0] == int(sel.sum()), (
                            f"target rows {raw.shape[0]} != selected atoms {sel.sum()}"
                        )
                        dense[sel] = raw
                    y[cfg.tensor_target_name] = dense
                    y["atom_selector"] = sel
                else:
                    y[cfg.tensor_target_name] = raw.reshape(1, tdim)
            for name, do_log in zip(
                cfg.scalar_target_names,
                cfg.log_scalar_targets or (False,) * len(cfg.scalar_target_names),
            ):
                v = np.atleast_2d(np.asarray(row[name], dtype=np.float64))
                y[name] = np.log(v) if do_log else v
            if cfg.tensor_target_weight and not dummy_targets:
                (col, table), = cfg.tensor_target_weight.items()
                x["target_weight"] = np.asarray([[table[row[col]]]])
            if cfg.atom_feats_columns:
                cols = []
                for c in cfg.atom_feats_columns:
                    v = np.asarray(row[c], dtype=np.float64).reshape(n, -1)
                    cols.append(v)
                af = np.concatenate(cols, axis=-1)
                if not np.isfinite(af).all():
                    raise ValueError("NaN/Inf in atom feats")
                x["atom_feats"] = af
            if cfg.global_feats_columns:
                gf = np.concatenate(
                    [
                        np.asarray(row[c], dtype=np.float64).reshape(1, -1)
                        for c in cfg.global_feats_columns
                    ],
                    axis=-1,
                )
                if not np.isfinite(gf).all():
                    raise ValueError("NaN/Inf in global feats")
                x["global_feats"] = gf
            g = CrystalGraph.from_structure(struct, r_cut=cfg.r_cut, x=x, y=y)
            graphs.append(g)
        except Exception as e:  # noqa: BLE001 — failure-tolerant conversion
            warnings.warn(f"Failed converting structure {i}; skipping: {e}")
            failed.append(i)
    if not graphs:
        raise RuntimeError("Cannot successfully convert any structures.")
    return graphs, failed


@dataclass
class DatasetStatistics:
    """Training-set statistics that travel with the checkpoint.

    The analog of the reference's `dataset_statistics.pt` sidecar
    (data/dataset.py:129-142, SURVEY.md §3.5): target normalizer state +
    the dataset->model hand-off (allowed species, average num neighbors).
    """

    allowed_species: Tuple[int, ...] = ()
    average_num_neighbors: float = 1.0
    target_normalizer: Optional[MeanNormNormalize] = None
    scalar_normalizers: Dict[str, ScalarNormalize] = field(default_factory=dict)
    # per-column standardizers for precomputed atom/global features
    # (reference ScalarFeatureTransform, data/transform.py:306-411)
    feature_normalizers: Dict[str, ScalarNormalize] = field(default_factory=dict)

    @classmethod
    def compute(
        cls,
        graphs: Sequence[CrystalGraph],
        cfg: TensorDatasetConfig,
        normalize_tensor_target: bool = False,
    ) -> "DatasetStatistics":
        zs = sorted({int(z) for g in graphs for z in g.atomic_numbers})
        avg_nn = float(np.mean(np.concatenate([g.num_neigh for g in graphs])))
        tnorm = None
        if cfg.tensor_target_name and cfg.tensor_target_format == "irreps":
            if cfg.per_atom:
                data = np.concatenate(
                    [g.y[cfg.tensor_target_name][g.y["atom_selector"]] for g in graphs]
                )
            else:
                data = np.concatenate([g.y[cfg.tensor_target_name] for g in graphs])
            tnorm = MeanNormNormalize(irreps=cfg.target_irreps)
            tnorm.compute_statistics(data)
            if not normalize_tensor_target:
                pass  # statistics still recorded for metrics/inspection
        scalar_norms: Dict[str, ScalarNormalize] = {}
        for name in cfg.scalar_target_names:
            vals = np.concatenate([np.atleast_2d(g.y[name]) for g in graphs])
            sn = ScalarNormalize(num_features=vals.shape[-1])
            sn.compute_statistics(vals)
            scalar_norms[name] = sn
        feat_norms: Dict[str, ScalarNormalize] = {}
        for name in ("atom_feats", "global_feats"):
            if graphs and name in graphs[0].x:
                vals = np.concatenate([np.atleast_2d(g.x[name]) for g in graphs])
                fn = ScalarNormalize(num_features=vals.shape[-1])
                fn.compute_statistics(vals)
                feat_norms[name] = fn
        return cls(
            allowed_species=tuple(zs),
            average_num_neighbors=avg_nn,
            target_normalizer=tnorm,
            scalar_normalizers=scalar_norms,
            feature_normalizers=feat_norms,
        )

    # ---- (de)serialization -------------------------------------------------
    def to_arrays(self) -> Dict[str, np.ndarray]:
        out = {
            "allowed_species": np.asarray(self.allowed_species, dtype=np.int64),
            "average_num_neighbors": np.asarray(self.average_num_neighbors),
        }
        if self.target_normalizer is not None and self.target_normalizer.initialized:
            out["target_mean"] = self.target_normalizer.mean
            out["target_norm"] = self.target_normalizer.norm
        for k, sn in self.scalar_normalizers.items():
            out[f"scalar_{k}_mean"] = sn.mean
            out[f"scalar_{k}_std"] = sn.std
        for k, fn in self.feature_normalizers.items():
            out[f"feat_{k}_mean"] = fn.mean
            out[f"feat_{k}_std"] = fn.std
        return out

    @classmethod
    def from_arrays(
        cls, arrays: Dict[str, np.ndarray], cfg: TensorDatasetConfig
    ) -> "DatasetStatistics":
        tnorm = None
        if "target_mean" in arrays:
            tnorm = MeanNormNormalize(
                irreps=cfg.target_irreps,
                mean=np.asarray(arrays["target_mean"]),
                norm=np.asarray(arrays["target_norm"]),
            )
        scalar_norms: Dict[str, ScalarNormalize] = {}
        feat_norms: Dict[str, ScalarNormalize] = {}
        for k in arrays:
            if k.startswith("scalar_") and k.endswith("_mean"):
                name = k[len("scalar_") : -len("_mean")]
                mean = np.asarray(arrays[k])
                std = np.asarray(arrays[f"scalar_{name}_std"])
                scalar_norms[name] = ScalarNormalize(
                    num_features=mean.shape[-1], mean=mean, std=std
                )
            elif k.startswith("feat_") and k.endswith("_mean"):
                name = k[len("feat_") : -len("_mean")]
                mean = np.asarray(arrays[k])
                std = np.asarray(arrays[f"feat_{name}_std"])
                feat_norms[name] = ScalarNormalize(
                    num_features=mean.shape[-1], mean=mean, std=std
                )
        return cls(
            allowed_species=tuple(int(z) for z in np.asarray(arrays["allowed_species"])),
            average_num_neighbors=float(arrays["average_num_neighbors"]),
            target_normalizer=tnorm,
            scalar_normalizers=scalar_norms,
            feature_normalizers=feat_norms,
        )

    def save(self, path) -> None:
        np.savez(path, **self.to_arrays())

    @classmethod
    def load(cls, path, cfg: TensorDatasetConfig) -> "DatasetStatistics":
        with np.load(path) as f:
            return cls.from_arrays(dict(f), cfg)
