"""Builds the package's CUDA sources with nvcc and loads them with ctypes.

Each library of ``LIBRARIES`` is built from its ``csrc/<source>.cu`` files
(plain C interfaces) into one shared library under ``build/kernels/`` at the
root of the checkout, compiled for sm_90a at first use: one source each,
except ``w8a8``, whose entry of a quantized site launches both of its
kernels. The library's file name carries a hash of its sources, so an edited
source is rebuilt and a stale library is never loaded. Nothing here runs when
the module is imported. No library links ``libcuda``: the int8 convolution
reaches ``cuTensorMapEncodeTiled`` through the runtime's
``cudaGetDriverEntryPoint``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARIES = {
    **{name: (name,) for name in (
        "flash_attention", "flash_attention_bwd", "flash_attention_tc",
        "flash_attention_wide_tc", "flash_attention_dq_tc", "flash_attention_dkv_tc",
        "flash_attention_wide_bwd_tc", "flash_attention_colsplit", "flash_attention_colsplit_tc",
        "msda_reduce", "patchify", "probe_gather", "probe_stream", "probe_msda_lab",
        "jv_assign",
    )},
    "w8a8": ("quant_act", "int8_conv"),
}
KERNEL_SOURCES = tuple(src for sources in LIBRARIES.values() for src in sources)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",  # registers, shared memory and spills of each kernel, into the log
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha1()
    sources = {f"{src}.cu" for src in LIBRARIES[name]}
    for src in sorted(CSRC.iterdir()):
        if src.name in sources or src.suffix == ".cuh":
            digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = tuple(LIBRARIES)) -> List[Path]:
    """Compile every missing library, one nvcc process per library, all
    started together. Returns the libraries' paths."""
    paths = {n: _library_path(n) for n in names}
    running = []
    for name, out in paths.items():
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / f"{src}.cu")
                                                      for src in LIBRARIES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, proc, tmp, out))
    failures = []
    for name, proc, tmp, out in running:  # wait for all, so none outlives us
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for library {name}:\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # a reader never sees a half-written library
    if failures:
        raise RuntimeError("\n".join(failures))
    return list(paths.values())


def resource_usage(path: Path) -> Dict[str, int]:
    """What ptxas reported for the kernels of one built library: the largest
    register count and the bytes spilled (0 means no kernel spills)."""
    log = path.with_suffix(".log").read_text()
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "spill_store_bytes": sum(spills)}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library `name` of ``LIBRARIES``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        (path,) = build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
