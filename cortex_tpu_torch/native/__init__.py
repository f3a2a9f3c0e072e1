"""The port's native host re-rank (C++ through ctypes), built at first use.

Counterpart of cortex_tpu/native (`build.load`, `graph.rerank_topk_native`),
limited to the one entry point the port calls: the threaded exact fp32
re-rank of device candidates against the host mirror
(`host_rerank.cpp`). The library is compiled with the reference's
flags (`g++ -O3 -march=native -shared -fPIC`, so both packages' re-ranks
round alike on one machine) into cortex_tpu_torch/_build/host/<hash>/,
keyed by a hash of the source and the flags, so an edited source
rebuilds and nothing is written beside the source.

As in the reference, the native tier is an accelerator, never a
dependency: `rerank_topk_native` returns None when g++ or the library
is unavailable (or CORTEX_NATIVE=0), and the caller keeps its numpy
path with the same tie order.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "host_rerank.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build" / "host"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def lib_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / h.hexdigest()[:16] / "libhost_rerank.so"


def _compile(out: Path) -> bool:
    if out.exists():
        return True
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        log.info("native host re-rank unavailable (%s); using numpy", e)
        return False
    os.replace(tmp, out)
    return True


def load() -> Optional[ctypes.CDLL]:
    """The ctypes library, built on first use, or None without it."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("CORTEX_NATIVE", "1") == "0":
            return None
        out = lib_path()
        if not _compile(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            log.info("failed to load the native host re-rank: %s", e)
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.host_rerank_topk.restype = ctypes.c_int32
        lib.host_rerank_topk.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int32, f32p, ctypes.c_int32,
            i32p, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, f32p, i32p]
        _LIB = lib
        return _LIB


def available() -> bool:
    return load() is not None


def rerank_topk_native(corpus: np.ndarray, queries: np.ndarray,
                       cand_rows: np.ndarray, valid: np.ndarray,
                       k: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Threaded exact fp32 re-rank of [B, cand] candidate rows against
    the corpus mirror. Returns (scores [B,k], rows [B,k]) — invalid
    slots score -1e30 — or None without the native lib. Tie order
    matches numpy's stable argsort of -scores."""
    lib = load()
    if lib is None:
        return None
    corpus = np.ascontiguousarray(corpus, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    cand_rows = np.ascontiguousarray(cand_rows, np.int32)
    valid = np.ascontiguousarray(valid, np.uint8)
    b, cand = cand_rows.shape
    scores = np.empty((b, k), np.float32)
    rows = np.empty((b, k), np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.host_rerank_topk(
        corpus.ctypes.data_as(f32p), corpus.shape[0], corpus.shape[1],
        queries.ctypes.data_as(f32p), b, cand_rows.ctypes.data_as(i32p),
        cand, valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), k,
        scores.ctypes.data_as(f32p), rows.ctypes.data_as(i32p))
    return scores, rows
