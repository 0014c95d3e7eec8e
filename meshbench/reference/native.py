"""ctypes bindings of the reference's frozen copy of the native mesh
library (``meshops.cpp`` beside this file): QSlim decimation and the
nearest-point barycentric transfer.

The library is built with g++ at first use into ``meshbench/_cache/build/``
(a fixed directory inside the checkout, so only the first run of a
checkout compiles it); its name carries a hash of the source and flags.
Nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "meshops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_cache", "build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def library_path() -> str:
    with open(SOURCE, "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libmeshops_ref_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """The library's path, compiled first if it is missing."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("the reference's mesh library needs g++")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"reference meshops build failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    dp, ip, i64 = (ctypes.POINTER(ctypes.c_double),
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_int64)
    lib.meshops_qslim.restype = i64
    lib.meshops_qslim.argtypes = [dp, i64, ip, i64, i64, ip, ip, ip]
    lib.meshops_transfer.restype = None
    lib.meshops_transfer.argtypes = [dp, i64, ip, i64, dp, i64, ip, dp]
    return lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def qslim(vertices: np.ndarray, faces: np.ndarray,
          target_vertices: int) -> tuple[np.ndarray, np.ndarray]:
    """(new faces over the kept vertices, kept parent vertex ids)."""
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int64)
    out_faces = np.empty_like(f)
    out_num_faces = np.zeros(1, dtype=np.int64)
    out_kept = np.empty(v.shape[0], dtype=np.int64)
    n_kept = library().meshops_qslim(
        _dptr(v), v.shape[0], _iptr(f), f.shape[0], int(target_vertices),
        _iptr(out_faces), _iptr(out_num_faces), _iptr(out_kept))
    if n_kept < 0:
        raise RuntimeError("meshops_qslim failed")
    return (out_faces[:int(out_num_faces[0])].copy(),
            out_kept[:int(n_kept)].copy())


def transfer(src_v: np.ndarray, src_f: np.ndarray,
             tgt_v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(cols [T, 3], weights [T, 3]) of the nearest surface point of each
    target vertex; col -1 marks an absent entry."""
    sv = np.ascontiguousarray(src_v, dtype=np.float64)
    sf = np.ascontiguousarray(src_f, dtype=np.int64)
    tv = np.ascontiguousarray(tgt_v, dtype=np.float64)
    cols = np.empty((tv.shape[0], 3), dtype=np.int64)
    weights = np.empty((tv.shape[0], 3), dtype=np.float64)
    library().meshops_transfer(_dptr(sv), sv.shape[0], _iptr(sf),
                               sf.shape[0], _dptr(tv), tv.shape[0],
                               _iptr(cols), _dptr(weights))
    return cols, weights
