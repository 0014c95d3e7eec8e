"""Build and load the port's CUDA kernels.

Each source in ``ops/csrc/`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``ops/_build/`` (not
committed), then loaded with ctypes. The library name carries a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds. Building happens at
first use; ``build_libraries`` starts one ``nvcc`` per source at once.
``csrc`` names another source directory (an older checkout's, for an A/B
of two builds in one process); its libraries carry their own hashes.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "meshvae_tpu_torch need the CUDA toolkit")
    return nvcc


def library_path(name: str, csrc: str = CSRC_DIR) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    sources = [os.path.join(csrc, f"{name}.cu")]
    for path in sources + sorted(glob.glob(os.path.join(csrc, "*.cuh"))):
        with open(path, "rb") as fp:
            digest.update(fp.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_libraries(names: list[str],
                    csrc: str = CSRC_DIR) -> dict[str, str]:
    """Compile every missing library in parallel; returns name -> the
    compiler's output (ptxas register and shared-memory report) for each
    source built now. Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name, csrc)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(csrc, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{logs[name]}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load_library(name: str, csrc: str = CSRC_DIR) -> ctypes.CDLL:
    """The library for <csrc>/<name>.cu, building it first if needed."""
    build_libraries([name], csrc)
    return ctypes.CDLL(library_path(name, csrc))


def ptxas_table(log: str) -> list[dict]:
    """One row per kernel instantiation of an nvcc log built with
    -Xptxas -v: its name with template arguments, registers, shared memory
    bytes and spill stores/loads."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"([A-Za-z_]+_kernel)I((?:L[a-z]\d+E)+)E", m.group(1))
            name = (f"{k.group(1)}<"
                    + ",".join(re.findall(r"L[a-z](\d+)E", k.group(2))) + ">"
                    if k else m.group(1))
            rows.append(dict(kernel=name, registers=None, smem=0,
                             spill_stores=0, spill_loads=0))
            continue
        if not rows:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[-1]["spill_stores"] = int(m.group(1))
            rows[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[-1]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            rows[-1]["smem"] = int(s.group(1)) if s else 0
    return rows
