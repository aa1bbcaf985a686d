"""Build and load the hand-written CUDA kernels (plain C interface, ctypes).

Each `csrc/<name>.cu` compiles on first use, one `nvcc` process per source
started together, to `_build/lib<name>-<hash>.so` next to this file (the
hash is of the source text, so an edited source rebuilds):

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
       -Xcompiler -fPIC -Xptxas -v

Nothing here runs at import, so every module imports on a machine without
`nvcc`; a build happens only where a kernel is launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCES = ("reprojection", "segsum")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that have no current library, all in
    parallel.  Returns {name: (seconds, compiler stderr)} for the sources
    it compiled; raises with the compiler output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp, out)
    report, errors = {}, []
    for n, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):"
                          f"\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        report[n] = (time.perf_counter() - t0, stderr)
    if errors:
        raise RuntimeError("\n".join(errors))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib
