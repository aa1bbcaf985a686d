"""The port stands alone: no file of `ba_tpu_torch/` (nor `chip_smoke.py`
or `profile_port.py`) imports jax or ba_tpu, importing the port leaves jax
out of sys.modules, each entry point raises when CUDA is absent and no
device="cpu" is given, and `chip_smoke.py` fails without a card."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "ba_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "profile_port.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_ba_tpu_imports(path):
    assert path.exists(), path
    bad = _imported_roots(path) & {"jax", "jaxlib", "ba_tpu"}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    mods = ["ba_tpu_torch", "ba_tpu_torch.convert",
            "ba_tpu_torch.io.simulate_vins", "ba_tpu_torch.solver.step",
            "ba_tpu_torch.solver.summary", "ba_tpu_torch.kernels.build",
            "ba_tpu_torch.kernels.reprojection",
            "ba_tpu_torch.kernels.segsum"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'ba_tpu')]\n"
              "assert not bad, bad\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("entry", ["builder", "build_problem",
                                   "problem_from_numpy"])
def test_entry_points_need_cuda_or_cpu(entry, monkeypatch):
    from ba_tpu_torch.convert import problem_from_numpy
    from ba_tpu_torch.core.problem import BAConfig, ProblemBuilder
    from ba_tpu_torch.io import simulate_vins as sv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = BAConfig(pose_dim=9)
    sim = sv.simulate(n_poses=4, n_lms=16, seed=0)
    if entry == "builder":
        b = ProblemBuilder(cfg)
        b.add_pose([1.0, 0, 0, 0], [0.0, 0, 0])
        call = b.build
    elif entry == "build_problem":
        def call(**kw):
            return sv.build_problem(sim, cfg, **kw)
    else:
        p, _, _ = sv.build_problem(sim, cfg, device="cpu")
        tree = _numpy_tree(p)

        def call(**kw):
            return problem_from_numpy(tree, **kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    out = call(device="cpu")
    p = out[0] if isinstance(out, tuple) else out
    assert p.poses.q.device.type == "cpu"


def _numpy_tree(problem):
    """The port's problem with numpy leaves (the shape of a converted JAX
    problem)."""
    from ba_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: np.asarray(t), problem)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """No CUDA here: the smoke script exits non-zero and prints no result,
    from the checkout and from a directory holding only the script."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        cwd = tmp_path
        (tmp_path / script.name).write_text(script.read_text())
        script = tmp_path / script.name
    out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
