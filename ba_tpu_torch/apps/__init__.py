"""Applications of the port, run as `python -m ba_tpu_torch.apps.<name>`:
`vins_stream` (the online streaming smoother, and the multi-stream
server), `vins_window` (the fixed-lag window, as a ring or as
solve-then-marginalize), `fleet_serve` (a fused vehicle fleet),
`unary_binary_imu_test` (the GPS + IMU pose-graph smoother, batch and
fixed-lag stream), `vins_csv` (a VINS solve of a sequence in the
reference's CSV format) and `math_test` (the kernel checks against finite
differences and a dense autodiff oracle)."""
