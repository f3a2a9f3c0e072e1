"""The port's native host kernels (C++ through ctypes), built at first use.

Counterpart of cortex_tpu/native (`build.load` and the wrappers of
`graph.py`), limited to the three entry points the port calls: the
threaded exact fp32 re-rank of device candidates against the host
mirror (`rerank_topk_native`, `host_rerank.cpp`), and the graph
engine's multi-source BFS with parents (`bfs_depths`) and connected
components (`components_native`, both `host_graph.cpp`). The two
sources are compiled with the reference's flags (`g++ -O3 -march=native
-shared -fPIC`, so both packages' re-ranks round alike on one machine)
into one library in cortex_tpu_torch/_build/host/<hash>/, keyed by a
hash of the sources and the flags, so an edited source rebuilds and
nothing is written beside the sources.

As in the reference, the native tier is an accelerator, never a
dependency: every wrapper returns None when g++ or the library is
unavailable (or CORTEX_NATIVE=0), and the caller keeps its Python or
numpy path with the same results and tie order.
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

_SRCS = tuple(Path(__file__).resolve().parent / name
              for name in ("host_rerank.cpp", "host_graph.cpp"))
_BUILD = Path(__file__).resolve().parent.parent / "_build" / "host"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def lib_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in _SRCS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / h.hexdigest()[:16] / "libcortex_host.so"


def _compile(out: Path) -> bool:
    if out.exists():
        return True
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp),
                        *(str(src) for src in _SRCS)],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        log.info("native host kernels unavailable (%s); using Python "
                 "paths", e)
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
            log.info("failed to load the native host kernels: %s", e)
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.host_rerank_topk.restype = ctypes.c_int32
        lib.host_rerank_topk.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int32, f32p, ctypes.c_int32,
            i32p, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, f32p, i32p]
        lib.gc_bfs.restype = ctypes.c_int64
        lib.gc_bfs.argtypes = [i32p, i32p, ctypes.c_int32, i32p,
                               ctypes.c_int32, ctypes.c_int32,
                               ctypes.c_int64, i32p, i32p]
        lib.gc_components.restype = ctypes.c_int32
        lib.gc_components.argtypes = [i32p, i32p, ctypes.c_int32, i32p]
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


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def bfs_depths(indptr: np.ndarray, indices: np.ndarray,
               sources: np.ndarray, *, max_depth: int = -1,
               max_visited: int = 0, want_parents: bool = False
               ) -> Optional[Tuple[np.ndarray, bool, Optional[np.ndarray]]]:
    """Multi-source BFS over CSR. Returns (depths [-1=unreached],
    truncated, parents|None) or None without the native lib."""
    lib = load()
    if lib is None:
        return None
    n = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    sources = np.ascontiguousarray(sources, np.int32)
    depths = np.empty(n, np.int32)
    parents = np.empty(n, np.int32) if want_parents else None
    rc = lib.gc_bfs(_i32(indptr), _i32(indices), n, _i32(sources),
                    len(sources), max_depth, max_visited, _i32(depths),
                    _i32(parents) if parents is not None else None)
    return depths, rc < 0, parents


def components_native(indptr: np.ndarray, indices: np.ndarray
                      ) -> Optional[np.ndarray]:
    """Connected-component labels over an undirected CSR, or None."""
    lib = load()
    if lib is None:
        return None
    n = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    comp = np.empty(n, np.int32)
    lib.gc_components(_i32(indptr), _i32(indices), n, _i32(comp))
    return comp
