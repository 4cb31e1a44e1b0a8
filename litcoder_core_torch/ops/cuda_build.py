"""Builds the port's CUDA sources with nvcc at first use and loads them.

Each source under litcoder_core_torch/csrc/ is compiled on its own into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

The library goes into litcoder_core_torch/_build/ (ignored by git), named
by a hash of every source and header under csrc/ and of the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it
is. No --use_fast_math: the kernels call sinf and must keep its accuracy.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# name -> (library, build report); one load per process.
_LOADED: Dict[str, Tuple[ctypes.CDLL, dict]] = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the CUDA kernels are built from source"
    )


def library_path(name: str) -> Path:
    """Where the library for csrc/<name>.cu is kept, keyed by the content of
    every *.cu and *.cuh file under csrc/ (a header may be included by any
    source) and by the flags."""
    source = CSRC_DIR / f"{name}.cu"
    if not source.is_file():
        raise FileNotFoundError(f"no CUDA source {source}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    files = sorted(p for pattern in ("*.cu", "*.cuh")
                   for p in CSRC_DIR.rglob(pattern))
    for path in files:
        h.update(str(path.relative_to(CSRC_DIR)).encode() + b"\0")
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, source: Path, output: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def load(name: str) -> Tuple[ctypes.CDLL, dict]:
    """Build csrc/<name>.cu if its library is missing, then load it.

    Returns (library, report) where report holds 'seconds' (0.0 when the
    library was already built) and 'log' (nvcc's ptxas report)."""
    if name in _LOADED:
        return _LOADED[name]
    lib_path = library_path(name)
    report = {"seconds": 0.0, "log": "", "path": str(lib_path)}
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build under a private name and rename, so a concurrent build or a
        # run cut short never leaves a half-written library behind.
        tmp_path = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(find_nvcc(), CSRC_DIR / f"{name}.cu", tmp_path)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        report["seconds"] = time.perf_counter() - t0
        report["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp_path.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{report['log']}"
            )
        os.replace(tmp_path, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = (lib, report)
    return lib, report
