"""Triangle-mesh OBJ I/O (counterpart of meshvae_tpu/mesh/io.py): the
native parser when the library can be built, then the Python parsers."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TriMesh:
    """A triangle mesh: vertices [N, 3] float64, faces [F, 3] int64 (0-based)."""

    v: np.ndarray
    f: np.ndarray

    def __post_init__(self):
        self.v = np.asarray(self.v, dtype=np.float64).reshape(-1, 3)
        self.f = np.asarray(self.f, dtype=np.int64).reshape(-1, 3)

    @property
    def num_vertices(self) -> int:
        return self.v.shape[0]

    @property
    def num_faces(self) -> int:
        return self.f.shape[0]


def _parse_obj_fast(text: str):
    """Vectorized parse of the plain-triangle dialect (`v x y z` / `f a b c`,
    positive 1-based indices). Returns (None, None) on anything fancier —
    texture/normal indices, polygons, negative indices — so the general
    parser keeps full coverage."""
    v_parts: list[str] = []
    f_parts: list[str] = []
    for line in text.splitlines():
        if line.startswith("v "):
            v_parts.append(line[2:])
        elif line.startswith("f "):
            if "/" in line:
                return None, None
            f_parts.append(line[2:])
    v_tokens = " ".join(v_parts).split()
    f_tokens = " ".join(f_parts).split()
    if len(v_tokens) != 3 * len(v_parts) or len(f_tokens) != 3 * len(f_parts):
        return None, None  # vertex w components or polygonal faces
    try:
        verts = np.asarray(v_tokens, dtype=np.float64).reshape(-1, 3)
        faces = np.asarray(f_tokens, dtype=np.int64).reshape(-1, 3)
    except ValueError:
        return None, None
    if faces.size and faces.min() <= 0:
        return None, None  # negative (end-relative) indices
    return verts, faces - 1


def load_obj(path: str) -> TriMesh:
    """Parse a Wavefront OBJ file (v/f lines; polygonal faces are
    fan-triangulated). Three tiers, same result: the native parser, the
    vectorized parser for the plain-triangle dialect, the general per-token
    parser for anything else."""
    from ..native import obj_parse_native

    native = obj_parse_native(path)
    if native is not None:
        return TriMesh(native[0], native[1])
    with open(path, "r") as fp:
        text = fp.read()
    fast_v, fast_f = _parse_obj_fast(text)
    if fast_v is not None:
        return TriMesh(fast_v, fast_f)

    verts: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    for line in text.splitlines():
        if line.startswith("v "):
            parts = line.split()
            verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif line.startswith("f "):
            # face entries may be "i", "i/t", "i/t/n", or "i//n"; 1-based,
            # negative indices are relative to the end of the vertex list.
            idx = []
            for tok in line.split()[1:]:
                i = int(tok.split("/")[0])
                idx.append(i - 1 if i > 0 else len(verts) + i)
            for k in range(1, len(idx) - 1):
                faces.append((idx[0], idx[k], idx[k + 1]))
    return TriMesh(np.array(verts, dtype=np.float64),
                   np.array(faces, dtype=np.int64).reshape(-1, 3))


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
             comment: str | None = None) -> None:
    """Write an OBJ with `v %f` / `f %d` lines; `comment` (no newlines) is
    emitted as a leading `# ` line."""
    vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    lines = []
    if comment:
        lines.append("# " + comment)
    for v in vertices:
        lines.append("v %f %f %f" % (v[0], v[1], v[2]))
    for f in faces + 1:
        lines.append("f %d %d %d" % (f[0], f[1], f[2]))
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")
