"""Applications of the port, run as `python -m ba_tpu_torch.apps.<name>`:
`vins_stream` (the online streaming smoother) and `vins_window` (the
fixed-lag window, as a ring or as solve-then-marginalize)."""
