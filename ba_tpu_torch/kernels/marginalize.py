"""K11: the marginalization prior of the departing poses (CUDA).

Replaces the TPU formulation `ba_tpu/solver/window.py:marginalize`
(:102-127): the departing dims are Schur-complemented out of the departing
system with a masked inverse (an n x n `inv` of which one k x k block is
used), the result is symmetrized, and `eigh` clips its negative
eigenvalues.  It runs once per marginalization (`solver/window.py`), once
per slide of the serving path.

Design (csrc/marginalize.cu), one block, no host read: (a) the departing
block (S_dd + eps I)^-1 inverted alone by Gauss-Jordan elimination with
partial pivoting (the d-block of ba_tpu's masked inverse, exactly), then
H = keep (S - S_:d X S_:d^T) keep and g = keep (rhs - S_:d X rhs_d),
symmetrized; (b) on the active dims only (rows of H not exactly zero), a
PSD certificate first: a blocked Cholesky of H_aa + tau I in f64 (tau =
1e-8 ||H||_F in f32, 1e-12 in f64; 32-column panels in shared memory, the
triangle on the L2-resident workspace).  If every pivot is positive, H has no
eigenvalue below -tau and is returned as it is: the clip would move it by
at most sqrt(#neg) tau, an order of magnitude under the kernel's
tolerances.  Only otherwise the PSD projection by cyclic Jacobi in
round-robin order (a pair table per round, then A <- J^T A J one 2 x 2
block per thread, two barriers a round), as H - sum of l v v^T over the
negative eigenvalues, with a threshold stop test on the device.  `info` =
(converged and finite, sweeps, clipped eigenvalues, departing dims,
rotations, certified) stays on the device: the serving path never reads
it.  On the certified branch sweeps, rotations and clipped are 0.

`marginalize_prior_plain` is its plain PyTorch version (the body
`window.marginalize` had: `inv_ex`, `eigh`); `solver/window.py:prior_step`
takes it for CPU tensors.

Bound on an H100: operations, n^3 / 3 for the certificate and ~12 n flops
per Jacobi rotation (a few MFLOP at the slide's n = 90); one block runs
it, so the chain of barriers sets its time: one per column of the factor,
one or two per Jacobi round.

Scope: float32 and float64, any n (with na active dims: the Jacobi's A
and V^T in shared memory up to na = 168 in f32 and 119 in f64, A alone up
to 238 and 168, the rest in the workspace).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, ctypes.c_double, _I, _P, _P, _P, _P, _P]

# Jacobi sweeps at most; the stop test ends it after ~5-10 (quadratic
# convergence)
MAX_SWEEPS = 30
INFO = ("ok", "sweeps", "clipped", "departing", "rotations", "certified")


def marginalize_prior_plain(S, rhs, pd, eps: float):
    """(H, g) of the prior: the dims `pd` ((n,) bool) Schur-complemented
    out of (S, rhs) with ba_tpu's masked inverse, kept dims only,
    symmetrized, negative eigenvalues clipped."""
    Pd = pd.to(S.dtype)
    B = (S * Pd[:, None] * Pd[None, :] + torch.diag(1.0 - Pd)
         + eps * torch.diag(Pd))
    Binv = torch.linalg.inv_ex(B).inverse
    # only the d-block of B^-1 matters; zero the rest to avoid leakage
    Binv = Binv * Pd[:, None] * Pd[None, :]
    SP = S * Pd[None, :]
    H = S - SP @ Binv @ SP.T
    g = rhs - SP @ (Binv @ (rhs * Pd))
    keep = 1.0 - Pd
    H = H * keep[:, None] * keep[None, :]
    g = g * keep
    # PSD safeguard (`solver/window.py`); a no-op to roundoff in f64
    H = 0.5 * (H + H.T)
    evals, evecs = torch.linalg.eigh(H)
    return (evecs * torch.clamp(evals, min=0.0)[None, :]) @ evecs.T, g


def _fn(dtype):
    lib = build.load("marginalize")
    name = {torch.float32: "ba_marginalize_f32",
            torch.float64: "ba_marginalize_f64"}[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def marginalize_prior(S, rhs, pd, eps: float):
    """(H, g, info) of `marginalize_prior_plain` on CUDA tensors, one
    launch of the kernel; `info` is an int32 (6,) device tensor (`INFO`)."""
    dev = S.device
    if not (S.is_cuda and rhs.device == dev and pd.device == dev):
        raise ValueError("marginalize kernel: S, rhs and pd must be on one "
                         "CUDA device")
    if S.dtype not in (torch.float32, torch.float64) \
            or rhs.dtype != S.dtype or pd.dtype != torch.bool:
        raise TypeError(f"marginalize kernel: unsupported dtypes {S.dtype}, "
                        f"{rhs.dtype}, {pd.dtype}")
    n = S.shape[0]
    if S.shape != (n, n) or rhs.shape != (n,) or pd.shape != (n,):
        raise ValueError(f"marginalize kernel: shapes S {tuple(S.shape)}, "
                         f"rhs {tuple(rhs.shape)}, pd {tuple(pd.shape)}")
    S, rhs, pd = S.contiguous(), rhs.contiguous(), pd.contiguous()
    H = torch.empty_like(S)
    g = torch.empty_like(rhs)
    info = torch.zeros((len(INFO),), dtype=torch.int32, device=dev)
    work = torch.empty((3 * n * n,), dtype=S.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn(S.dtype)(S.data_ptr(), rhs.data_ptr(), pd.data_ptr(), n,
                      float(eps), MAX_SWEEPS, work.data_ptr(), H.data_ptr(),
                      g.data_ptr(), info.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"marginalize kernel launch failed: CUDA error "
                           f"{rc}")
    marginalize_prior.launches += 1
    return H, g, info


marginalize_prior.launches = 0
