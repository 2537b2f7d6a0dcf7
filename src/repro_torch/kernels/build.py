"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared library
with a plain C interface (loaded with ``ctypes``; no PyTorch headers, which
would take minutes to compile).  The libraries go into
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a
hash of the sources and flags, and are built at first use: all sources at
once, one ``nvcc`` process each.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "build_dir", "build_all", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("lowrank_matmul", "lowrank_ffn", "lowrank_bwd", "int8_matmul", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# after the source: dlopen, through which the large-M K1/K5 reach the
# cuTensorMapEncodeTiled in libcuda (which no library links)
LIBS = ("-ldl",)
_TIMEOUT_S = 900

_loaded: Dict[str, ctypes.CDLL] = {}


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels need the CUDA toolkit to build")


def build_dir() -> Path:
    """The directory this checkout's sources and flags build into."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LIBS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return _repo_root() / "build" / "repro_torch_kernels" / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; return name -> path.

    The compiles run in parallel.  Each writes ``<name>.log`` (nvcc's output,
    with ``-Xptxas -v`` register and shared-memory counts) beside the library.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {name: out / f"lib{name}.so" for name in SOURCES}
    todo = [n for n, p in libs.items() if not p.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu"), *LIBS]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {_TIMEOUT_S} s"
        (out / f"{name}.log").write_text(log)
        if proc.returncode == 0:
            os.replace(tmp, libs[name])
        else:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built on first use)."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build_all()[name]))
        err = getattr(lib, f"repro_{name}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]
