"""IVF gather-score: the probed-block scan of the IVF search.

`probed_scores` is the counterpart of cortex_tpu/ops/ivf_gather.py::
probed_scores (the Pallas kernel). It dispatches on the tensors'
device and has exactly two branches:

  * CUDA tensors run the hand-written kernel in csrc/ivf_gather.cu,
    bound as torch.ops.cortex_tpu_torch.probed_scores and built with
    nvcc at first use into cortex_tpu_torch/_build/<source hash>/. A
    failed build or launch raises.
  * CPU tensors run `probed_scores_plain`, the same function in plain
    torch (the CPU tests use it, and chip_smoke.py holds the kernel
    against it on the card).

The layout is the port's: the metadata the Pallas kernel packed into a
[C, 8, L] f32 plane arrives as separate [C, L] planes (rinv f32;
slot_rows, kind_sl, agent_sl int32), and p is not padded to a multiple
of 8. Scores carry no 1/qs query descale, exactly as in the reference.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import torch

from .similarity import NEG_INF

NO_FILTER = -1          # filter list entry: filter off / pad (shard.py)
PLAIN_BUDGET_BYTES = 1 << 30    # f32 gather per query chunk, plain version

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_SOURCES = ("ivf_gather.cu", "ivf_gather_op.cpp")
_NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++20", "-shared", "-Xcompiler", "-fPIC")
_LIB_NAME = "libcortex_tpu_torch_ops.so"

_load_lock = threading.Lock()
_op = None                      # the op handle, once the library is loaded


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def build_library() -> Path:
    """Compile csrc/ into a shared library and return its path. The
    output directory is keyed by a hash of the sources, the flags and
    the torch version, so an edited source always rebuilds and an
    unchanged one is built once per checkout. Raises RuntimeError with
    the compiler's output when nvcc fails."""
    from torch.utils.cpp_extension import include_paths, library_paths

    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    srcs = [_CSRC / s for s in _SOURCES]
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    h.update(f"{torch.__version__} abi={abi}".encode())
    out_dir = _BUILD / h.hexdigest()[:16]
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{_LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_NVCC_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
           *(f"-I{p}" for p in include_paths()),
           *(str(s) for s in srcs),
           *(f"-L{p}" for p in library_paths()),
           "-lc10", "-ltorch_cpu", "-ltorch", "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {lib}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_op():
    """Build (if needed) and load the kernel library once per process;
    returns the op handle. After the first call this is one global read:
    the lock is taken only while the handle is unset."""
    global _op
    if _op is None:
        with _load_lock:
            if _op is None:
                torch.ops.load_library(str(build_library()))
                _op = torch.ops.cortex_tpu_torch.probed_scores
    return _op


def probed_scores(emb_i8, rinv_sl, slot_rows, kind_sl, agent_sl, probe,
                  qi8, ak, aa, ex, *, filtered: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused gather + score + filter pass over the probed blocks.

    emb_i8 [C, L, d] int8; rinv_sl [C, L] f32; slot_rows / kind_sl /
    agent_sl [C, L] int32; probe [B, p] int32; qi8 [B, d] int8; ak [16] /
    aa [1] / ex [64] int32 filter lists (shard.py encoding). filtered=
    False drops the kind/agent/exclusion tests and REQUIRES the lists to
    be all NO_FILTER. Returns (scores [B, p*L] f32: q_i8 . row_i8 * rinv,
    NEG_INF where masked; rows [B, p*L] int32: the raw slot rows)."""
    dev = emb_i8.device
    if dev.type == "cuda":
        out = load_op()(emb_i8, rinv_sl, slot_rows, kind_sl, agent_sl,
                        probe, qi8, ak, aa, ex, bool(filtered))
        probed_scores.launches += 1
        return out
    if dev.type == "cpu":
        return probed_scores_plain(emb_i8, rinv_sl, slot_rows, kind_sl,
                                   agent_sl, probe, qi8, ak, aa, ex,
                                   filtered=filtered)
    raise RuntimeError(f"probed_scores has no kernel for device {dev}")


#: kernel launches since the last reset (chip_smoke.py reads it to show
#: the main path went through the kernel)
probed_scores.launches = 0


def probed_scores_plain(emb_i8, rinv_sl, slot_rows, kind_sl, agent_sl,
                        probe, qi8, ak, aa, ex, *, filtered: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`probed_scores` in plain torch: gather the probed blocks, f32
    batched matmul (exact: int8 products summed below 2^24), times rinv,
    then the masks. Materializes the [n, p*L, d] f32 gather, so queries
    run in chunks of at most PLAIN_BUDGET_BYTES each."""
    if emb_i8.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("probed_scores_plain needs TF32 off: the f32 "
                           "product must be exact")
    b, p = probe.shape
    c, l, d = emb_i8.shape
    if b == 0:
        return (torch.empty((0, p * l), dtype=torch.float32,
                            device=emb_i8.device),
                torch.empty((0, p * l), dtype=torch.int32,
                            device=emb_i8.device))
    qc = max(1, min(b, PLAIN_BUDGET_BYTES // max(1, p * l * d * 4)))
    s_parts, r_parts = [], []
    for s0 in range(0, b, qc):
        pr = probe[s0:s0 + qc].long()
        n = pr.shape[0]
        blk = emb_i8[pr].reshape(n, p * l, d).float()
        q = qi8[s0:s0 + qc].float().unsqueeze(2)
        s = torch.bmm(blk, q).squeeze(2) * rinv_sl[pr].reshape(n, p * l)
        rows = slot_rows[pr].reshape(n, p * l)
        ok = rows >= 0
        if filtered:
            kc = kind_sl[pr].reshape(n, p * l)
            ac = agent_sl[pr].reshape(n, p * l)
            kind_on = ak[0] != NO_FILTER
            ok &= ~kind_on | torch.isin(kc, ak)
            agent_on = aa[0] != NO_FILTER
            ok &= ~agent_on | (ac == aa[0])
            ok &= ~torch.isin(rows, ex)
        s_parts.append(torch.where(ok, s, torch.full_like(s, NEG_INF)))
        r_parts.append(rows)
    return torch.cat(s_parts), torch.cat(r_parts)
