"""chip_smoke.py without a GPU, its configuration, and the main path's imports."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

yaml = pytest.importorskip("yaml")


def _run(script_dir: Path, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script_dir / "chip_smoke.py"), *args],
        cwd=script_dir, env=env, capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_fails_without_a_gpu(tmp_path, where):
    script_dir = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        script_dir = tmp_path
    proc = _run(script_dir)
    assert proc.returncode != 0
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and "device" not in last


@pytest.mark.parametrize(
    "attr, config",
    [
        ("ELASTICITY_MODEL", "materials_tensor_production.yaml"),
        ("NMR_MODEL", "atomic_tensor.yaml"),
    ],
)
def test_model_sections_equal_the_yaml(attr, config):
    with open(REPO / "scripts" / "configs" / config) as f:
        assert getattr(chip_smoke, attr) == yaml.safe_load(f)["model"]


@pytest.mark.parametrize("kind", ["elasticity", "nmr"])
def test_synthetic_sets_load(tmp_path, kind):
    from matten_tpu.data.dataset import TensorDatasetConfig, load_tensor_dataset

    if kind == "elasticity":
        chip_smoke.write_elasticity_set(tmp_path / "d.json", 6, seed=0)
        cfg = TensorDatasetConfig()
    else:
        chip_smoke.write_nmr_set(tmp_path / "d.json", 6, seed=0)
        cfg = TensorDatasetConfig(
            tensor_target_name="nmr_tensor", tensor_target_formula="ij=ji",
            atom_selector="atom_selector",
        )
    graphs, failed = load_tensor_dataset(tmp_path / "d.json", cfg)
    assert failed == [] and len(graphs) == 6
    for g in graphs:
        assert chip_smoke.ATOMS[0] <= g.num_nodes <= chip_smoke.ATOMS[1]
        assert set(int(z) for z in g.atomic_numbers) <= set(chip_smoke.SPECIES)


IMPORTS = {
    "models": "import matten_tpu.models",
    "train": "import matten_tpu.train; from matten_tpu.train.trainer import Trainer",
    "predict": "from matten_tpu.predict import predict",
    "datamodule": "import matten_tpu.data.datamodule",
    "scripts": (
        f"import sys; sys.path.insert(0, {str(REPO / 'scripts')!r}); "
        "from train_materials_tensor import main; from train_atomic_tensor import main"
    ),
}


@pytest.mark.parametrize("entry", sorted(IMPORTS))
def test_main_path_imports_only_the_promised_packages(entry):
    code = (
        f"{IMPORTS[entry]}\n"
        "import sys\n"
        f"print([m for m in {chip_smoke.OFF_PATH!r} if m in sys.modules])\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
