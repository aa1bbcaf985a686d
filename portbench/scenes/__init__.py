"""Seeded scene generators, one module per kind of configuration.

A configuration file names its generator by `"scene"`; the harness imports
`portbench.scenes.<scene>` and calls its `generate(config, mix, seed,
device)`, which returns a `Scene` (`scene.py`): the true states, the start
states the solve begins from, the measurements and the structure, all in
float64 on `device`.  The same seed gives the same scene.  Both sides of
the benchmark take their inputs from one `Scene`: the program through
`port.problem` (in the configuration's precision), the plain reference
through `Scene.rounded` (the same rounded numbers, in float64).
"""
