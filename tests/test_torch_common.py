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
                pad_multiple=1, with_marg_prior=True):
    """(JAX problem before prepare_landmarks, JAX BAConfig, SimData)."""
    cfg = jprob.BAConfig(pose_dim=pose_dim, lm_size=1, use_dogleg=False)
    sim = jsv.simulate(n_poses=n_poses, n_lms=n_lms, seed=0)
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
