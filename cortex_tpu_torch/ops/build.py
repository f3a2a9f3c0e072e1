"""One build of the port's CUDA kernels, shared by every op module.

Every source under csrc/ (`*.cu`, `*.cpp`) is compiled with nvcc for
sm_90a and linked into one shared library, which registers the ops of
the `torch.ops.cortex_tpu_torch` namespace. The sources compile side by
side (one nvcc process each, all started together), then one nvcc
command links them. The library lands in
cortex_tpu_torch/_build/<hash>/, keyed by a hash of every source, the
flags and the torch version, so an edited source always rebuilds and an
unchanged tree builds once per checkout. Nothing here runs at import
time: the first CUDA call of an op builds and loads the library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++20", "-Xcompiler", "-fPIC")
_LIB_NAME = "libcortex_tpu_torch_ops.so"

_load_lock = threading.Lock()
_ops = None                     # torch.ops.cortex_tpu_torch, once loaded


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def sources() -> List[Path]:
    """Every kernel and binding source, in a fixed order."""
    return sorted(p for p in _CSRC.iterdir()
                  if p.suffix in (".cu", ".cpp", ".cuh"))


def _run(cmd, what: str) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {what}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")


def build_library() -> Path:
    """Compile csrc/ into one shared library and return its path.
    Raises RuntimeError with the compiler's output when nvcc fails."""
    from torch.utils.cpp_extension import include_paths, library_paths

    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    srcs = sources()
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    h.update(f"{torch.__version__} abi={abi}".encode())
    out_dir = _BUILD / h.hexdigest()[:16]
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    common = [*_NVCC_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
              f"-I{_CSRC}", *(f"-I{p}" for p in include_paths())]
    units = [s for s in srcs if s.suffix != ".cuh"]
    objs = [out_dir / f"{s.name}.{pid}.o" for s in units]
    procs = [(subprocess.Popen(
        [_nvcc(), *common, "-c", str(s), "-o", str(o)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), s)
        for s, o in zip(units, objs)]
    failed = []
    for p, s in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"{s.name} ({p.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed building " + "\n".join(failed))
    tmp = out_dir / f"{_LIB_NAME}.{pid}.tmp"
    _run([_nvcc(), *_NVCC_FLAGS, "-shared", *(str(o) for o in objs),
          *(f"-L{p}" for p in library_paths()),
          "-lc10", "-ltorch_cpu", "-ltorch", "-o", str(tmp)], str(lib))
    os.replace(tmp, lib)
    for o in objs:
        o.unlink(missing_ok=True)
    return lib


def load_ops():
    """Build (if needed) and load the kernel library once per process;
    returns the torch.ops.cortex_tpu_torch namespace. After the first
    call this is one global read: the lock is taken only while unset."""
    global _ops
    if _ops is None:
        with _load_lock:
            if _ops is None:
                torch.ops.load_library(str(build_library()))
                _ops = torch.ops.cortex_tpu_torch
    return _ops
