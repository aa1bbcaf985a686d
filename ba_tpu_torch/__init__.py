"""ba_tpu_torch — the PyTorch/CUDA port of `ba_tpu` for one NVIDIA H100.

The JAX package `ba_tpu` stays the reference; this package mirrors its
layout module for module (core/, core/residuals/, io/, solver/, utils/,
parallel/: the sharded solves on `torch.distributed`) and
adds kernels/ with the hand-written CUDA kernels of its paths, one
source each in kernels/csrc/ (`kernels/build.py:SOURCES`):

  reprojection.cu  reprojection residual + closed-form Jacobians (the
                   retired Pallas kernel), with self-calibration's columns
  imu_preint.cu    IMU preintegration with Jacobians and covariance, and
                   without, whitened in the epilogue (K2)
  segsum.cu        grouped deterministic segmented block sum (the
                   normal-equation sums of a build)
  band_schur.cu    grouped banded Schur correction (the long-trajectory
                   banded solver, kernel 7)
  band_matvec.cu   symmetric block-band product (its PCG, kernel 9)
  schur_matvec.cu  the projection rows of the matrix-free Schur product
                   and their landmark-sorted pack (the PCG solver, kernel 6)
  fleet_schur.cu   the scaled per-window Schur system of a fused vehicle
                   fleet, straight from the W blocks (kernel 10)
  schur_finish.cu  the dense Schur step S = U - W V^-1 W^T and its rhs (K5)
  marginalize.cu   the marginalization prior, its PSD certificate and
                   Jacobi clip (K11)
  band_to_dense.cu the dense symmetric matrix of a block band (K5b)
  chunk_layout.cu  the Jacobi-scaled band and its chunk blocks (K8a)
  chunk_factor.cu  the chunked block-tridiagonal factor: cyclic reduction
                   with explicit triangular inverses, or the scan (K8b)
  chunk_solve.cu   its solves: mat-vecs under cyclic reduction (K8c)

(with the shared headers dual_lie.cuh, tile_walk.cuh and chunk_blas.cuh).

native/ holds the host code (C++ built with g++ at first use): the GPS +
IMU smoother's interpolation buffer and log parser, and the problem
builder (`native.NativeProblemBuilder`).

Every kernel has a plain PyTorch version beside it.  A wrapper takes the
plain version only for CPU tensors; a CUDA tensor goes through the kernel or
raises.  The package imports torch and numpy, never jax or ba_tpu.

Entry points (`ProblemBuilder.build`, `io.simulate_vins.build_problem`,
`convert.problem_from_numpy`) put tensors on `cuda` unless the caller passes
`device="cpu"`; the solver runs on whatever device the Problem lives on.
"""

import torch

# Full-f32 products: reduced-precision matmuls made the assembled
# Gauss-Newton Hessian indefinite in the reference (ba_tpu/__init__.py).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point places its tensors on; raises when CUDA is
    asked for (the default) and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ba_tpu_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path")
    return dev
