"""Hand-written CUDA kernels of the main path and their ctypes wrappers.

  reprojection.py  kernel 1: reprojection residual + closed-form Jacobians
  segsum.py        kernel 2: grouped deterministic segmented block sum,
                   on segment plans built once per solve

Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises on a non-zero `cudaGetLastError()`, and
counts its launches in `<wrapper>.launches`.  The plain PyTorch versions
live beside the dispatch (`core/residuals/reprojection.py:evaluate_plain`,
`solver/assemble.py:_seg_sum_plain`, `segsum.plan_walk`).
"""
