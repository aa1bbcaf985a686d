"""portbench: the benchmark of ba_tpu_torch, the PyTorch and CUDA port.

One command runs one cell once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by the names in the root `BENCHMARK.json`:
its configuration (`configs/`), its traffic mix (`mixes/`), the program
entry the mix names (`entries/`), its limits (`limits/<workload>.json`),
the scene generator the configuration names (`scenes/`), one reader a
metric (`metrics/<metric>.py`, which also declares the spans, taps and
kernel counts it needs) and the kernels' operation and byte counts
(`rooflines/`).  The plain reference that decides `correct` is
`reference/`.  `calibrate.py` takes the readings the limits are set from,
`sets.py` the full sets the bounds are set from.
"""
