"""Seconds from the process start to the end of the warm-up solve:
imports, the scene, the program's problem, and the kernels loaded (built,
on a checkout's first run)."""


def read(ctx):
    return ctx["setup_s"]
