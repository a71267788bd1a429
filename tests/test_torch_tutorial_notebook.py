"""The port's tutorial notebook (``mri_interpolation_tpu_torch/examples/
tutorial.ipynb``) against its generator and against ``docs/tutorial.ipynb``,
which is not edited.

- The committed notebook is ``make_tutorial_notebook.build()``: nbformat 4,
  at least 8 code and 8 markdown cells, no outputs, no execution counts.
- Its code cells build the same models, with the same keyword arguments (the
  port's ``device`` aside), and the same ``TrainConfig``s as
  ``docs/tutorial.ipynb``'s cells, in order.
- Its code cells run top to bottom on the CPU (``DEVICE = "cpu"``) at
  ``EPOCHS = 12``, as JAX's own notebook test runs its cells, the cells'
  assertion (SIREN and hash grid above 20 dB) included; the 2x upsampled
  volume has twice the time axis. At ``EPOCHS = 2`` that assertion fails by
  construction (on the CPU: SIREN 19.3, hash grid 17.2 dB).
"""

import ast
import json
from pathlib import Path

import numpy as np

from mri_interpolation_tpu_torch.examples import make_tutorial_notebook as mk

REPO = Path(__file__).resolve().parents[1]


def committed() -> dict:
    return json.loads(Path(mk.NOTEBOOK).read_text())


def test_notebook_is_the_generator_s_and_clean():
    nb = committed()
    assert nb == mk.build(), "tutorial.ipynb is stale: rerun python -m " \
                             "mri_interpolation_tpu_torch.examples.make_tutorial_notebook"
    assert nb["nbformat"] == 4
    kinds = [c["cell_type"] for c in nb["cells"]]
    assert kinds.count("code") >= 8 and kinds.count("markdown") >= 8
    assert len(kinds) == len(json.loads((REPO / "docs" / "tutorial.ipynb").read_text())["cells"]) == 20
    for c in nb["cells"]:
        if c["cell_type"] == "code":
            assert c["outputs"] == [] and c["execution_count"] is None


def test_main_writes_the_notebook(tmp_path, capsys):
    out = tmp_path / "nb.ipynb"
    assert mk.main([str(out)]) == str(out)
    assert json.loads(out.read_text()) == mk.build()
    assert "20 cells (10 code)" in capsys.readouterr().out


def calls(notebook: dict, prefix: str):
    """(function, positional args, keyword args but ``device``) of every call
    to a function whose name starts with ``prefix``, in the cells' order."""
    out = []
    for src in mk.code_cells(notebook):
        tree = ast.parse(src)
        for node in ast.walk(tree):  # the port's device=, in nested calls too
            if isinstance(node, ast.Call):
                node.keywords = [k for k in node.keywords if k.arg != "device"]
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id.startswith(prefix):
                out.append((node.func.id, [ast.unparse(a) for a in node.args],
                            sorted((k.arg, ast.unparse(k.value)) for k in node.keywords)))
    return out


def test_same_models_and_configs_as_the_jax_notebook():
    jax_nb = json.loads((REPO / "docs" / "tutorial.ipynb").read_text())
    for prefix in ("make_", "TrainConfig", "demo", "synthetic_volume", "dataset_from_array"):
        got, want = calls(committed(), prefix), calls(jax_nb, prefix)
        assert got == want and got, prefix
    assert len(calls(committed(), "make_")) == 7


def test_cells_run_top_to_bottom_on_the_cpu(capsys):
    ns = {}
    for i, src in enumerate(mk.code_cells(committed())):
        src = src.replace('DEVICE = "cuda"', 'DEVICE = "cpu"').replace("EPOCHS = 40", "EPOCHS = 12")
        exec(compile(src, f"<tutorial.ipynb cell {i}>", "exec"), ns)  # noqa: S102
    assert ns["DEVICE"] == "cpu" and ns["EPOCHS"] == 12
    assert ns["p_siren"] > 20 and ns["p_hash"] > 20
    assert ns["upsampled"].shape == ns["shape"][:-1] + (2 * ns["shape"][-1],)
    assert np.isfinite(ns["upsampled"]).all() and np.isfinite(ns["q"]["odd"]["psnr"])
    assert next(ns["proto_model"].parameters()).device.type == "cpu"
    assert "held-out odd-frame PSNR" in capsys.readouterr().out
