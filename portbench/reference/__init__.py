"""The plain reference the benchmark judges the program against.

Plain PyTorch, run in float64 by default: `ba.solve` repeats a cell's
whole solve (Gauss-Newton over the Schur-reduced camera system,
the reduced solve as the configuration states it) from the same scene,
with Jacobians taken by `torch.func` from residuals written here
(`geometry.py`, `imu.py`) and a dense reduced system per window.  It
imports nothing of the program, of `jax` or of `ba_tpu`, and takes nothing
the program made: it derives the landmark parameterization, the robust
weights, the IMU covariances and every structure table itself.
"""
