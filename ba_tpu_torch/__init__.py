"""ba_tpu_torch — the PyTorch/CUDA port of `ba_tpu` for one NVIDIA H100.

The JAX package `ba_tpu` stays the reference; this package mirrors its
layout module for module (core/, core/residuals/, io/, solver/, utils/) and
adds kernels/ with the hand-written CUDA kernels of its paths:

  kernels/csrc/reprojection.cu  reprojection residual + closed-form
                                Jacobians (the retired Pallas kernel),
                                with self-calibration's columns
  kernels/csrc/imu_preint.cu    IMU preintegration with Jacobians and
                                covariance, and without (K2)
  kernels/csrc/segsum.cu        grouped deterministic segmented block sum
                                (the normal-equation sums of a build)
  kernels/csrc/band_schur.cu    grouped banded Schur correction (the
                                long-trajectory banded solver)
  kernels/csrc/band_matvec.cu   symmetric block-band product (its PCG)
  kernels/csrc/schur_matvec.cu  the projection rows of the matrix-free
                                Schur product (the PCG solver)
  kernels/csrc/fleet_schur.cu   W operands and scaled Schur system of a
                                fused vehicle fleet

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
