"""Dataset files are read with `json`, as `pandas.read_json` reads them."""

import numpy as np
import pytest

from matten_tpu.data.dataset import TensorDatasetConfig, load_tensor_dataset, read_json_rows
from matten_tpu.data.structure import Structure

pd = pytest.importorskip("pandas")


def _frame(n=5, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        s = Structure(
            np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1,
            rng.uniform(0, 1, (3, 3)),
            rng.choice([8, 14], 3),
        )
        t = rng.normal(size=(3, 3, 3, 3))
        t = (t + t.transpose(1, 0, 2, 3)) / 2
        t = (t + t.transpose(0, 1, 3, 2)) / 2
        t = (t + t.transpose(2, 3, 0, 1)) / 2
        rows.append(
            {
                "structure": s.to_dict(),
                "elastic_tensor_full": t.tolist(),
                "band_gap": float(rng.uniform(0, 3)),
            }
        )
    return pd.DataFrame(rows)


@pytest.mark.parametrize("orient", ["columns", "records"])
def test_rows_equal_pandas(tmp_path, orient):
    path = tmp_path / "t.json"
    _frame().to_json(path, orient=orient)
    # precise_float: pandas' default float parser rounds the last digit
    want = pd.read_json(path, precise_float=True).to_dict(orient="records")
    assert read_json_rows(path) == want


@pytest.mark.parametrize("orient", ["columns", "records"])
def test_dataset_loads_in_both_orientations(tmp_path, orient):
    path = tmp_path / "t.json"
    _frame().to_json(path, orient=orient)
    graphs, failed = load_tensor_dataset(path, TensorDatasetConfig(scalar_target_names=("band_gap",)))
    assert failed == [] and len(graphs) == 5
    ref = _frame()
    for g, t, gap in zip(graphs, ref["elastic_tensor_full"], ref["band_gap"]):
        assert g.y["elastic_tensor_full"].shape == (1, 21)
        np.testing.assert_allclose(g.y["band_gap"], [[gap]])
        assert g.num_nodes == 3


def test_rejects_other_layouts(tmp_path):
    path = tmp_path / "t.json"
    path.write_text("[1, 2, 3]")
    with pytest.raises(ValueError, match="orient"):
        read_json_rows(path)
