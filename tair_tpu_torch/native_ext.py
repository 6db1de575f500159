"""Native (C++) host helpers, built with g++ at first use and loaded by ctypes.

Counterpart of ``tair_tpu/native_ext.py``, from the port's own copies of its
sources (``tair_tpu_torch/native/{lapjv,cocoeval}.cpp``). Ships
``lapjv_batch``, the batched Hungarian solver behind the "hungarian_host"
matcher, and ``coco_ap``, the COCO AP accumulator behind
``utils/text_eval.average_precision``. The library is compiled with the JAX
package's flags, so both give the same bits, into ``build/native/`` at the
root of the checkout; its file name carries a hash of the sources, the
compiler and the flags, so an edited source is rebuilt and a stale library is
never loaded. Unlike the JAX package, a build that fails raises: there is no
fallback. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parent / "native"
SOURCES = ("lapjv.cpp", "cocoeval.cpp")
COMPILER = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")  # tair_tpu/native_ext.py's

_LIB: Optional[ctypes.CDLL] = None
_FLOAT_P, _INT_P = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)


def build_dir() -> Path:
    return Path(__file__).resolve().parents[1] / "build" / "native"


def library_path() -> Path:
    digest = hashlib.sha1()
    for name in SOURCES:
        digest.update((SOURCE_DIR / name).read_bytes())
    digest.update(" ".join((COMPILER, *CXX_FLAGS)).encode())
    return build_dir() / f"libtair_native_{digest.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [COMPILER, *CXX_FLAGS, *(str(SOURCE_DIR / s) for s in SOURCES), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        raise RuntimeError(f"the native helpers cannot be built: {err}") from err
    if proc.returncode != 0:
        raise RuntimeError(f"the native helpers failed to build ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)  # a reader never sees a half-written library


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built if needed."""
    global _LIB
    if _LIB is None:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.lapjv_batch.argtypes = [_FLOAT_P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    _INT_P, _INT_P]
        lib.lapjv_batch.restype = None
        lib.coco_ap.argtypes = [_FLOAT_P, _FLOAT_P, _INT_P, _INT_P, ctypes.c_int,
                                _FLOAT_P, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
        lib.coco_ap.restype = None
        _LIB = lib
    return _LIB


def _solve(lib, cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    b, q, m = cost.shape
    out = np.empty((b, m), np.int32)
    lib.lapjv_batch(cost.ctypes.data_as(_FLOAT_P), b, q, m,
                    n_valid.ctypes.data_as(_INT_P), out.ctypes.data_as(_INT_P))
    return out


def lapjv_batch(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """cost [B, Q, M] float32, n_valid [B] -> [B, M] int32 query per target,
    -1 for padding. A batch element with more valid targets than queries
    (which the C solver, assigning every valid target, would search forever)
    is solved transposed: each of the Q queries takes one of its targets, the
    rest get -1, as scipy's rectangular solve does."""
    lib = get_lib()
    cost = np.ascontiguousarray(cost, np.float32)
    n_valid = np.ascontiguousarray(n_valid, np.int32)
    b, q, m = cost.shape
    n = np.minimum(n_valid, m)
    wide = n > q
    out = _solve(lib, cost, np.where(wide, 0, n_valid).astype(np.int32))
    for k in np.flatnonzero(wide):
        target4query = _solve(lib, np.ascontiguousarray(cost[k, :, : n[k]].T)[None],
                              np.asarray([q], np.int32))[0]
        out[k] = -1
        out[k, target4query] = np.arange(q, dtype=np.int32)
    return out


def coco_ap(
    ious: Sequence[np.ndarray],       # per image [n_pred_i, n_gt_i]
    scores: Sequence[np.ndarray],     # per image [n_pred_i]
    thresholds: Sequence[float],
) -> np.ndarray:
    """COCO AP accumulation (the native cocoeval counterpart): [n_thr] float64."""
    lib = get_lib()
    n_pred = np.asarray([m.shape[0] for m in ious], np.int32)
    n_gt = np.asarray([m.shape[1] for m in ious], np.int32)
    iou_flat = (
        np.concatenate([np.ascontiguousarray(m, np.float32).reshape(-1) for m in ious])
        if len(ious) else np.zeros(0, np.float32)
    )
    sc_flat = (
        np.concatenate([np.ascontiguousarray(s, np.float32).reshape(-1) for s in scores])
        if len(scores) else np.zeros(0, np.float32)
    )
    thr = np.ascontiguousarray(thresholds, np.float32)
    out = np.empty(len(thr), np.float64)
    lib.coco_ap(
        iou_flat.ctypes.data_as(_FLOAT_P), sc_flat.ctypes.data_as(_FLOAT_P),
        n_pred.ctypes.data_as(_INT_P), n_gt.ctypes.data_as(_INT_P), len(ious),
        thr.ctypes.data_as(_FLOAT_P), len(thr),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out
