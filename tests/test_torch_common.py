"""Shared helpers for the PyTorch-port equivalence tests, plus the checks of
the port's configuration and problem conversion.

The JAX side is `ba_tpu` on the CPU in f64 (tests/conftest.py); the port
side is `ba_tpu_torch` on device="cpu", which runs the plain PyTorch
versions of the kernels.  Both get the identical problem: the JAX builder's
output, carried across leaf by leaf with `problem_from_numpy`.
"""

import dataclasses
import functools

import jax
import numpy as np
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.io import simulate_vins as jsv
from ba_tpu.solver import assemble as jasm
from ba_tpu_torch.convert import problem_from_numpy
from ba_tpu_torch.core import problem as tprob


def assert_rel(got, want, tol, what=""):
    """max |got - want| <= tol * max(1, max |want|), NaNs in the same
    places."""
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size == 0:
        return
    if want.dtype == bool or not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    got, want = got[~nan], want[~nan]
    if want.size == 0:
        return
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3g} > {tol:g} * {scale:.3g}"


@functools.lru_cache(maxsize=None)
def jax_problem(n_poses=12, n_lms=48, pose_dim=9, perturb=0.01, seed=1,
                pad_multiple=1, with_marg_prior=True, speed=1.0):
    """(JAX problem before prepare_landmarks, JAX BAConfig, SimData); a
    faster trajectory (`speed`) sees each landmark from fewer poses, so its
    band is narrower."""
    cfg = jprob.BAConfig(pose_dim=pose_dim, lm_size=1, use_dogleg=False)
    sim = jsv.simulate(n_poses=n_poses, n_lms=n_lms, seed=0, speed=speed)
    p, _, _ = jsv.build_problem(sim, cfg, perturb=perturb, seed=seed,
                                pad_multiple=pad_multiple,
                                with_marg_prior=with_marg_prior)
    return p, cfg, sim


def to_torch(jp):
    """The port's Problem on the CPU holding the JAX problem's values."""
    return problem_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")


def torch_config(jcfg, **changes):
    """The port's BAConfig with the same field values as a JAX BAConfig."""
    cfg = tprob.BAConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(jcfg)})
    return dataclasses.replace(cfg, **changes)


def banded_case(n_poses=24, mask=True, with_marg_prior=False, speed=1.0,
                **cfg):
    """Prepared problems on both sides for the banded solvers: band width
    from the problem, `use_banded_solver` on unless `cfg` says otherwise,
    one pose with masked dims.  No marginalization prior by default: with
    one, the banded solver's gate sends the build to the dense path."""
    jp, jcfg, _ = jax_problem(n_poses=n_poses, n_lms=int(2.5 * n_poses),
                              with_marg_prior=with_marg_prior, speed=speed)
    jcfg = dataclasses.replace(jcfg, **{
        "band_width": jasm.band_width_of(jp), "use_banded_solver": True,
        **cfg})
    if mask:
        m = np.asarray(jp.poses.mask).copy()
        m[4, :6] = False
        jp = dataclasses.replace(jp, poses=dataclasses.replace(
            jp.poses, mask=jax.numpy.asarray(m)))
    jp = jprob.prepare_landmarks(jp, jcfg)
    return jp, jcfg, to_torch(jp), torch_config(jcfg)


def with_random_prior(jp, scale=0.1, seed=1):
    """The JAX problem with an active random dense marginalization prior
    (its H PSD)."""
    rng = np.random.default_rng(seed)
    n = jp.marg.H.shape[0]
    A = rng.standard_normal((n, n)) * scale
    return dataclasses.replace(jp, marg=dataclasses.replace(
        jp.marg, H=jax.numpy.asarray(A @ A.T),
        g=jax.numpy.asarray(rng.standard_normal(n) * scale),
        lin_t=jp.marg.lin_t + 0.01 * scale,
        active=jax.numpy.ones((), bool)))


def assert_tree_rel(got, want, tol, what="problem"):
    """Leafwise comparison of a port tree against a JAX tree."""
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(w):
            assert_tree_rel(g, w, tol, f"{what}.{f.name}")
        else:
            assert_rel(g, w, tol, f"{what}.{f.name}")


def test_baconfig_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jprob.BAConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tprob.BAConfig)]
    assert tf == jf
    for kw in ({}, dict(pose_dim=15, calib_size=5, do_tvs=True)):
        j, t = jprob.BAConfig(**kw), tprob.BAConfig(**kw)
        for prop in ("vel_in_state", "bias_in_state", "calib_dim",
                     "tvs_offset"):
            assert getattr(t, prop) == getattr(j, prop), prop


def test_problem_from_numpy_keeps_every_leaf():
    jp, _, _ = jax_problem(pad_multiple=4)
    tp = to_torch(jp)
    assert_tree_rel(tp, jp, 0.0)
    assert tp.poses.q.dtype == torch.float64
    assert tp.proj.pose.dtype == torch.int32
    assert tp.proj.valid.dtype == torch.bool
    assert tp.imu.c9_set.shape == ()


class CpuBuilder(tprob.ProblemBuilder):
    """The port's ProblemBuilder emitting on the CPU by default, for scene
    functions written against ba_tpu's builder (they call `build()` with
    no device)."""

    def build(self, pad_multiple=1, with_marg_prior=True, device="cpu"):
        return super().build(pad_multiple, with_marg_prior, device)


def both_scenes(monkeypatch, module, fn, *args, **kw):
    """(ba_tpu's output, the port's output) of a scene function of a
    ba_tpu test module: the same numpy scene from the same seed fed once
    to ba_tpu's ProblemBuilder and BAConfig, once to the port's (on the
    CPU)."""
    want = fn(*args, **kw)
    with monkeypatch.context() as m:
        m.setattr(module, "ProblemBuilder", CpuBuilder)
        m.setattr(module, "BAConfig", tprob.BAConfig)
        got = fn(*args, **kw)
    return want, got


def assert_eval_matches(got, want, tol=1e-10, what="reprojection"):
    """Every field of a port ProjEval against ba_tpu's."""
    for name in want._fields:
        assert_rel(getattr(got, name), getattr(want, name), tol,
                   f"{what}.{name}")


def assert_solve_matches(got, want, tol=1e-8):
    """A port `solve` against ba_tpu's: the same iteration count and
    result code, the final cost, poses and landmarks to `tol`."""
    (p_t, s_t), (p_j, s_j) = got, want
    assert (s_t.iterations, s_t.result) == (s_j.iterations, s_j.result)
    assert_rel(np.array(s_t.final_cost), np.array(s_j.final_cost), tol,
               "final_cost")
    for name in ("q", "t"):
        assert_rel(getattr(p_t.poses, name), getattr(p_j.poses, name), tol,
                   f"poses.{name}")
    assert_rel(p_t.lms.x, p_j.lms.x, tol, "lms.x")
    assert_rel(p_t.lms.x_w, p_j.lms.x_w, tol, "lms.x_w")
