"""Batched camera models: linear (pinhole), FOV, poly3 and equidistant.

Port of `ba_tpu/core/camera.py`.  Models are pure functions of
(params, point); Jacobians come from `torch.func.jacfwd` at the call site.

Parameter layouts (leading entries of a fixed-width `params` vector):
  linear:      [fx, fy, cx, cy]
  fov:         [fx, fy, cx, cy, w]   (FOV distortion of Devernay & Faugeras)
  poly3:       [fx, fy, cx, cy, k1, k2, k3]  (r_d = r_u (1 + k1 r_u^2 +
               k2 r_u^4 + k3 r_u^6); unprojection by fixed-iteration Newton)
  equidistant: [fx, fy, cx, cy]  (fisheye r_d = atan(r_u))

Dispatch is by `torch.where` over the model id, so a mixed-model rig still
evaluates in one batch.
"""

from __future__ import annotations

import torch

MODEL_LINEAR = 0
MODEL_FOV = 1
MODEL_POLY3 = 2
MODEL_EQUIDISTANT = 3

# widest parameter vector across models (poly3: 7)
MAX_PARAMS = 7
_SMALL = 1e-9


def _p(params, i):
    """params[..., i], tolerating vectors shorter than MAX_PARAMS."""
    if params.shape[-1] > i:
        return params[..., i]
    return torch.zeros_like(params[..., 0])


def _fov_factor(params, r_u):
    """Distorted/undistorted radius ratio for the FOV model, Taylor-safe:
    factor(r) = atan(2 r tan(w/2)) / (r w);  lim_{r->0} = 2 tan(w/2)/w."""
    w = _p(params, 4)
    tan_half = torch.tan(0.5 * w)
    small_r = r_u < _SMALL
    r_safe = torch.where(small_r, torch.ones_like(r_u), r_u)
    small_w = w.abs() < _SMALL
    w_safe = torch.where(small_w, torch.ones_like(w), w)
    mul = 2.0 * tan_half
    lin = torch.atan(r_safe * mul) / (r_safe * w_safe)
    lim = mul / w_safe
    factor = torch.where(small_r, lim, lin)
    return torch.where(small_w, torch.ones_like(factor), factor)


def _poly3_factor(params, r_u):
    """r_d / r_u for the radial polynomial model."""
    k1, k2, k3 = _p(params, 4), _p(params, 5), _p(params, 6)
    r2 = r_u * r_u
    return 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))


def _equi_factor(r_u):
    """r_d / r_u = atan(r)/r for the equidistant fisheye, Taylor-safe."""
    small = r_u < _SMALL
    r_safe = torch.where(small, torch.ones_like(r_u), r_u)
    f = torch.atan(r_safe) / r_safe
    return torch.where(small, torch.ones_like(f), f)


def project(params, model, ray):
    """Pixel coordinates (..., 2) of a sensor-frame ray (..., 3), z forward."""
    z = ray[..., 2]
    zero = (z == 0).to(z.dtype)
    z_safe = torch.where(z.abs() < _SMALL,
                         torch.sign(z) * _SMALL + zero * _SMALL, z)
    xn = ray[..., 0] / z_safe
    yn = ray[..., 1] / z_safe
    r_u = torch.sqrt(xn * xn + yn * yn)
    one = torch.ones_like(r_u)
    factor = torch.where(
        model == MODEL_FOV, _fov_factor(params, r_u),
        torch.where(model == MODEL_POLY3, _poly3_factor(params, r_u),
                    torch.where(model == MODEL_EQUIDISTANT,
                                _equi_factor(r_u), one)))
    fx, fy = params[..., 0], params[..., 1]
    cx, cy = params[..., 2], params[..., 3]
    return torch.stack([fx * factor * xn + cx, fy * factor * yn + cy],
                       dim=-1)


def _poly3_inv_factor(params, r_d):
    """r_u / r_d by a fixed-iteration Newton solve of
    r_u (1 + k1 r_u^2 + ...) = r_d."""
    small = r_d < _SMALL
    rd = torch.where(small, torch.ones_like(r_d), r_d)
    k1, k2, k3 = _p(params, 4), _p(params, 5), _p(params, 6)
    ru = rd
    for _ in range(8):
        r2 = ru * ru
        f = ru * (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))) - rd
        df = 1.0 + r2 * (3.0 * k1 + r2 * (5.0 * k2 + r2 * 7.0 * k3))
        ru = ru - f / torch.where(df.abs() < _SMALL, torch.ones_like(df), df)
    inv = ru / rd
    return torch.where(small, torch.ones_like(inv), inv)


def unproject(params, model, pix):
    """Unit-norm sensor-frame ray for pixel(s) `pix` (..., 2)."""
    fx, fy = params[..., 0], params[..., 1]
    cx, cy = params[..., 2], params[..., 3]
    xd = (pix[..., 0] - cx) / fx
    yd = (pix[..., 1] - cy) / fy
    r_d = torch.sqrt(xd * xd + yd * yd)
    w = _p(params, 4)
    tan_half = torch.tan(0.5 * w)
    small = (r_d < _SMALL) | (w.abs() < _SMALL)
    r_safe = torch.where(small, torch.ones_like(r_d), r_d)
    # inverse FOV distortion: r_u = tan(r_d w) / (2 tan(w/2))
    inv_fov = torch.tan(r_safe * w) / (2.0 * tan_half * r_safe)
    inv_fov = torch.where(small, torch.ones_like(inv_fov), inv_fov)
    # inverse equidistant: r_u = tan(r_d), with its own r-guard
    small_e = r_d < _SMALL
    r_safe_e = torch.where(small_e, torch.ones_like(r_d), r_d)
    inv_equi = torch.tan(r_safe_e) / r_safe_e
    inv_equi = torch.where(small_e, torch.ones_like(inv_equi), inv_equi)
    factor = torch.where(
        model == MODEL_FOV, inv_fov,
        torch.where(model == MODEL_POLY3, _poly3_inv_factor(params, r_d),
                    torch.where(model == MODEL_EQUIDISTANT, inv_equi,
                                torch.ones_like(inv_fov))))
    ray = torch.stack([xd * factor, yd * factor, torch.ones_like(xd)],
                      dim=-1)
    return ray / torch.sqrt(torch.sum(ray * ray, dim=-1, keepdim=True))
