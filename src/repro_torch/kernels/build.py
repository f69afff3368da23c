"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C entry point and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library at first use, loaded
with ``ctypes``.  Libraries are named by a hash of their source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and an unchanged one is reused.  The build
directory is ``repro_torch/_build`` (ignored by git).  What ptxas reports
for a library (``-Xptxas -v``: each kernel's registers, shared memory,
stack frame and spills) is kept beside it (:func:`report_path`) and read
by :func:`ptxas_report`.  :func:`build_counts` counts the ``nvcc`` runs
and the library loads since :func:`reset_build_counts` (the port's
single-build contract, ``analysis/op_audit.py``'s C204).  Nothing here
runs at import: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
KERNELS = ("pairwise_stats", "fused_select", "dequant_stats", "coord_select",
           "pairwise_stats_rect", "dequant_stats_rect", "pairwise_sqdist")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: nvcc processes started by :func:`build` and libraries loaded by
#: :func:`library` since :func:`reset_build_counts`
_COUNTS = {"nvcc_runs": 0, "library_loads": 0}


def build_counts() -> Dict[str, int]:
    """{"nvcc_runs", "library_loads"} since :func:`reset_build_counts`."""
    return dict(_COUNTS)


def reset_build_counts() -> None:
    for key in _COUNTS:
        _COUNTS[key] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda; "
                       "the CUDA kernels build only where the toolkit is")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def report_path(name: str) -> Path:
    """Where the compiler's output of :func:`library_path`'s build is
    kept."""
    return library_path(name).with_suffix(".ptxas.txt")


def nvcc_command(name: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Sequence[str] = KERNELS) -> Tuple[float, Dict[str, str]]:
    """Compile the named kernels that are not built yet, one ``nvcc`` each,
    all started together.  Returns (seconds, {name: compiler output}) and
    raises ``RuntimeError`` with the compiler's output if one fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
        _COUNTS["nvcc_runs"] += 1
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            # the report first: a library that exists has its report,
            # unless it was built before reports were kept
            report_path(name).write_text(logs[name])
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return time.perf_counter() - t0, logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    _COUNTS["library_loads"] += 1
    return lib


def parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """{mangled kernel name: {"registers", "smem_bytes", "stack_frame",
    "spill_stores", "spill_loads"}} from nvcc's ``-Xptxas -v`` output (a
    stack frame is local memory: an array the compiler could not keep in
    registers; ``smem_bytes`` is static shared memory)."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": 0, "smem_bytes": 0, "stack_frame": 0,
                         "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack_frame=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(s.group(1)) if s else 0
    return out


def ptxas_report(name: str) -> Optional[Dict[str, Dict[str, int]]]:
    """:func:`parse_ptxas` of the kept report of ``csrc/<name>.cu``'s
    library; None where there is none (nothing built here, or a library
    built before reports were kept)."""
    path = report_path(name)
    return parse_ptxas(path.read_text()) if path.exists() else None
