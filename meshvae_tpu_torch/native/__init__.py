"""ctypes bindings for the native mesh-preprocessing library (counterpart of
meshvae_tpu/native/__init__.py, with its own copy of ``meshops.cpp``).

``library()`` builds ``meshops.cpp`` with g++ at first call into
``meshvae_tpu_torch/ops/_build/`` (not committed; the file name carries a
hash of the source and flags, so an edited source rebuilds) and loads it.
Nothing is built when the module is imported. Without a C++ compiler it
returns None and the mesh functions keep their numpy paths, which compute
the same results (tests/test_torch_scaled.py holds the two equal).

``CALLS`` counts the native calls per entry point, so a run can show that
its hierarchy and its meshes went through the library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "meshops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "ops", "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

CALLS = {"qslim": 0, "transfer": 0, "obj_parse": 0}


def library_path() -> str:
    with open(SOURCE, "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmeshops_{digest.hexdigest()[:16]}.so")


def _compiler() -> str | None:
    return shutil.which("g++") or shutil.which("c++")


def build() -> tuple[str, float]:
    """Compile the library if it is missing; returns (path, seconds spent
    compiling, 0.0 when it was already built). Raises when no compiler is
    found or the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out, 0.0
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found for meshops.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"meshops build failed ({cxx} exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent reader never sees a partial file
    return out, time.perf_counter() - t0


@functools.cache
def library():
    """The loaded library, built first if needed; None without a C++
    compiler. A compiler that is present but fails raises."""
    if _compiler() is None and not os.path.exists(library_path()):
        return None
    lib = ctypes.CDLL(build()[0])
    dp, ip, i64 = (ctypes.POINTER(ctypes.c_double),
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_int64)
    lib.meshops_qslim.restype = i64
    lib.meshops_qslim.argtypes = [dp, i64, ip, i64, i64, ip, ip, ip]
    lib.meshops_transfer.restype = None
    lib.meshops_transfer.argtypes = [dp, i64, ip, i64, dp, i64, ip, dp]
    lib.meshops_obj_parse.restype = i64
    lib.meshops_obj_parse.argtypes = [ctypes.c_char_p, dp, i64, ip, i64,
                                      ip, ip]
    return lib


def available() -> bool:
    return library() is not None


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def qslim_decimate_native(vertices: np.ndarray, faces: np.ndarray,
                          target_vertices: int):
    """Native QSlim; returns (new_faces, kept_parent_ids) or None if the
    library is unavailable."""
    lib = library()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int64)
    out_faces = np.empty_like(f)
    out_num_faces = np.zeros(1, dtype=np.int64)
    out_kept = np.empty(v.shape[0], dtype=np.int64)
    n_kept = lib.meshops_qslim(_dptr(v), v.shape[0], _iptr(f), f.shape[0],
                               int(target_vertices), _iptr(out_faces),
                               _iptr(out_num_faces), _iptr(out_kept))
    if n_kept < 0:
        raise RuntimeError("meshops_qslim failed")
    CALLS["qslim"] += 1
    return (out_faces[: int(out_num_faces[0])].copy(),
            out_kept[: int(n_kept)].copy())


def barycentric_transfer_native(src_v: np.ndarray, src_f: np.ndarray,
                                tgt_v: np.ndarray):
    """Native closest-point transfer; returns (cols [T,3], weights [T,3])
    with col = -1 marking absent entries, or None if unavailable."""
    lib = library()
    if lib is None:
        return None
    sv = np.ascontiguousarray(src_v, dtype=np.float64)
    sf = np.ascontiguousarray(src_f, dtype=np.int64)
    tv = np.ascontiguousarray(tgt_v, dtype=np.float64)
    cols = np.empty((tv.shape[0], 3), dtype=np.int64)
    weights = np.empty((tv.shape[0], 3), dtype=np.float64)
    lib.meshops_transfer(_dptr(sv), sv.shape[0], _iptr(sf), sf.shape[0],
                         _dptr(tv), tv.shape[0], _iptr(cols), _dptr(weights))
    CALLS["transfer"] += 1
    return cols, weights


def obj_parse_native(path: str):
    """Native single-pass parse of the plain-triangle OBJ dialect; returns
    (verts [N,3] f64, faces [F,3] i64 0-based) or None when the library is
    unavailable or the file uses a construct outside the dialect (the
    caller then takes the Python parser)."""
    lib = library()
    if lib is None:
        return None
    try:
        size = os.path.getsize(path)
    except OSError:
        return None
    # a v/f line is >= 8 bytes, so size // 8 + 1 bounds both counts
    cap = size // 8 + 1
    verts = np.empty((cap, 3), dtype=np.float64)
    faces = np.empty((cap, 3), dtype=np.int64)
    nv = np.zeros(1, dtype=np.int64)
    nf = np.zeros(1, dtype=np.int64)
    rc = lib.meshops_obj_parse(path.encode(), _dptr(verts), cap,
                               _iptr(faces), cap, _iptr(nv), _iptr(nf))
    if rc != 0:
        return None
    CALLS["obj_parse"] += 1
    return verts[: int(nv[0])].copy(), faces[: int(nf[0])].copy()
