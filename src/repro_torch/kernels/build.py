"""Build and load the package's CUDA kernels (nvcc + ctypes).

Each `csrc/<name>.cu` compiles on first use into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o csrc/build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads the library already built.
`csrc/build/` is ignored by git. `start` / `finish` let a caller run one
nvcc per source at the same time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: dict[str, ctypes.CDLL] = {}
#: ptxas's report (registers, spills) of each library built by this
#: process, by kernel name.
PTXAS_LOG: dict[str, str] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def start(name: str) -> subprocess.Popen | None:
    """Start nvcc for ``name`` unless its library exists; returns the
    process (or None if there is nothing to build)."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    return subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(name: str, proc: subprocess.Popen | None) -> Path:
    """Wait for ``proc`` and move its library into place."""
    lib = library_path(name)
    if proc is None:
        return lib
    log, _ = proc.communicate()
    PTXAS_LOG[name] = log
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib


def build_all(names) -> dict[str, Path]:
    """Build every kernel in ``names`` with one nvcc each, all at once."""
    procs = {n: start(n) for n in names}
    return {n: finish(n, p) for n, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(finish(name, start(name))))
    return _LOADED[name]
