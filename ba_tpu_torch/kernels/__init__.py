"""Hand-written CUDA kernels of the main path and their ctypes wrappers.

  reprojection.py  kernel 1: reprojection residual + closed-form Jacobians
                   (with the calibration columns of self-calibration)
  imu_preint.py    K2 (`imu_preint`): IMU preintegration of every span,
                   with and without Jacobians
  segsum.py        segsum: grouped deterministic segmented block sum,
                   on segment plans built once per solve
  band_schur.py    kernel 7: grouped banded Schur correction
  band_matvec.py   kernel 9: symmetric block-band product
  schur_matvec.py  kernel 6: the projection family's share of the
                   matrix-free Schur product (the PCG solver)
  fleet_schur.py   kernel 10: the W operands and the scaled per-window
                   Schur system of a fused fleet
  schur_finish.py  K5: the dense Schur step S = U - W V^-1 W^T and its
                   rhs, with the column mask (every dense build and
                   marginalization)
  marginalize.py   K11: the departing dims' Schur complement into the
                   prior and its PSD clip (Jacobi), no host read
  band_to_dense.py K5b: the dense symmetric matrix of a block band (the
                   flagship's banded grid, `schur_on_band`)
  chunk_tridiag.py K8a (`chunk_layout`): the Jacobi-scaled band and its
                   chunk blocks in one launch; K8b (`bcr_factor`,
                   `scan_factor`): the chunked block-tridiagonal factor by
                   cyclic reduction or the scan; K8c (`bcr_solve`,
                   `scan_solve`): its solves (the banded solver)

Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises on a non-zero `cudaGetLastError()`, and
counts its launches in `<wrapper>.launches`.  The plain PyTorch versions
live beside the dispatch (`core/residuals/reprojection.py:evaluate_plain`,
`core/residuals/imu.py:full_plain` and `residual_plain`,
`solver/assemble.py:_seg_sum_plain`, `segsum.plan_walk`,
`solver/banded.py:band_schur_plain` and `band_matvec_plain`,
`schur_matvec.schur_matvec_plain`, `fleet_schur.fleet_w_plain` and
`fleet_epilogue_plain`, `schur_finish.schur_finish_plain`,
`marginalize.marginalize_prior_plain`,
`solver/assemble.py:band_to_dense_plain`, and `solver/banded.py`'s
`jacobi_scaled` with `chunk_system` (K8a), `_bcr_factor` and `_factor`
(K8b), `_bcr_solve` and `_solve_factored` (K8c)).
"""
