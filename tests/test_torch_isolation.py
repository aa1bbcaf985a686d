"""The port stands alone: no file of `ba_tpu_torch/` (nor `chip_smoke.py`
or `profile_port.py`) imports jax or ba_tpu, importing the port leaves jax
out of sys.modules, each entry point (the builders, the converters, the
streaming smoother, the calibration service and the three apps, the
multi-stream server among them) raises when CUDA is absent and no
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
            "ba_tpu_torch.kernels.segsum", "ba_tpu_torch.solver.window",
            "ba_tpu_torch.solver.fixedlag", "ba_tpu_torch.solver.streaming",
            "ba_tpu_torch.apps.vins_stream", "ba_tpu_torch.apps.vins_window",
            "ba_tpu_torch.solver.cg", "ba_tpu_torch.solver.banded",
            "ba_tpu_torch.kernels.band_schur",
            "ba_tpu_torch.kernels.band_matvec",
            "ba_tpu_torch.kernels.schur_matvec",
            "ba_tpu_torch.kernels.fleet_schur",
            "ba_tpu_torch.apps.fleet_serve", "ba_tpu_torch.calib",
            "ba_tpu_torch.kernels.imu_preint",
            "ba_tpu_torch.solver.linear",
            "ba_tpu_torch.kernels.schur_finish",
            "ba_tpu_torch.kernels.marginalize"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'ba_tpu')]\n"
              "assert not bad, bad\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("entry", ["builder", "build_problem",
                                   "problem_from_numpy",
                                   "ring_schedule_from_numpy",
                                   "streaming_ring", "vi_calibrator"])
def test_entry_points_need_cuda_or_cpu(entry, monkeypatch):
    from ba_tpu_torch.convert import (problem_from_numpy,
                                      ring_schedule_from_numpy)
    from ba_tpu_torch.core.problem import (BAConfig, ProblemBuilder,
                                           prepare_landmarks)
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import fixedlag
    from ba_tpu_torch.solver.streaming import RingCapacities, StreamingRing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = BAConfig(pose_dim=9)
    sim = sv.simulate(n_poses=4, n_lms=16, seed=0)
    if entry == "vi_calibrator":
        from ba_tpu_torch.calib import ViCalibrator

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ViCalibrator(np.zeros((4, 3)))
        assert ViCalibrator(np.zeros((4, 3)), device="cpu").device.type \
            == "cpu"
        return
    if entry == "builder":
        b = ProblemBuilder(cfg)
        b.add_pose([1.0, 0, 0, 0], [0.0, 0, 0])
        call = b.build
    elif entry == "build_problem":
        def call(**kw):
            return sv.build_problem(sim, cfg, **kw)
    elif entry == "problem_from_numpy":
        p, _, _ = sv.build_problem(sim, cfg, device="cpu")
        tree = _numpy_tree(p)

        def call(**kw):
            return problem_from_numpy(tree, **kw)
    else:
        p, _, _ = sv.build_problem(sim, cfg, device="cpu",
                                   with_marg_prior=False)
        sched = fixedlag.build_ring_schedule(
            prepare_landmarks(p, cfg), cfg, 2)
        if entry == "ring_schedule_from_numpy":
            def call(**kw):
                return ring_schedule_from_numpy(sched, **kw)
        else:
            caps = RingCapacities.from_schedule(sched)

            def call(**kw):
                return StreamingRing(cfg, 2, p.rig, p.g_vec, caps, **kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    out = call(device="cpu")
    if entry == "streaming_ring":
        assert out.rig.params.device.type == "cpu"
        return
    if entry == "ring_schedule_from_numpy":
        assert out.carry0[0].device.type == "cpu"
        return
    p = out[0] if isinstance(out, tuple) else out
    assert p.poses.q.device.type == "cpu"


@pytest.mark.parametrize("app,args", [
    ("vins_stream", ["--poses", "7", "--lms", "28", "--window", "4"]),
    ("vins_stream", ["--poses", "6", "--lms", "24", "--window", "4",
                     "--streams", "2"]),
    ("vins_window", ["--poses", "7", "--lms", "28", "--window", "5",
                     "--ring"]),
    ("vins_window", ["--poses", "7", "--lms", "28", "--window", "6"]),
    ("fleet_serve", ["--vehicles", "2", "--poses", "6", "--lms", "20",
                     "--iters", "2"])],
    ids=["vins_stream", "vins_stream_many", "vins_window_ring",
         "vins_window", "fleet_serve"])
def test_apps_need_cuda_or_cpu(app, args, monkeypatch, capsys):
    """Each app raises without CUDA and runs on the CPU with --device cpu
    (tiny sizes: a few slides or marginalization steps)."""
    import importlib

    mod = importlib.import_module(f"ba_tpu_torch.apps.{app}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(args)
    assert mod.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "on cpu" in out and "ATE" in out


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
