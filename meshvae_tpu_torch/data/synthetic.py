"""Synthetic dataset generation (counterpart of
meshvae_tpu/data/synthetic.py): smooth low-frequency deformations of the
template plus a class-dependent systematic component and a random
similarity pose, written as `subj{i}_{f|m}_synth.obj`."""
from __future__ import annotations

import os

import numpy as np

from ..mesh.io import TriMesh, save_obj


def _smooth_displacement(v: np.ndarray, rng: np.random.Generator,
                         n_modes: int = 8, scale: float = 1.0) -> np.ndarray:
    """Low-frequency smooth displacement field: random cosine modes over space."""
    extent = v.max(axis=0) - v.min(axis=0)
    extent[extent == 0] = 1.0
    disp = np.zeros_like(v)
    for _ in range(n_modes):
        freq = rng.uniform(0.5, 2.0, size=3) / extent
        phase = rng.uniform(0, 2 * np.pi, size=3)
        amp = rng.normal(0, scale, size=3)
        disp += amp * np.cos(2 * np.pi * (v * freq).sum(axis=1, keepdims=True)
                             + phase)
    return disp


def generate_synthetic_dataset(
    template: TriMesh,
    out_dir: str,
    n_samples: int = 64,
    seed: int = 0,
    deform_scale: float = 0.01,
    class_scale: float = 0.02,
    pose: bool = True,
) -> list[str]:
    """Write n_samples deformed copies of the template; returns filenames."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    v = np.asarray(template.v)
    bbox = float(np.linalg.norm(v.max(0) - v.min(0)))

    class_rng = np.random.default_rng(seed + 10_000)
    signatures = [
        _smooth_displacement(v, class_rng, n_modes=6, scale=class_scale * bbox / 6),
        _smooth_displacement(v, class_rng, n_modes=6, scale=class_scale * bbox / 6),
    ]

    names = []
    for i in range(n_samples):
        label = i % 2  # balanced classes
        tag = "f" if label == 0 else "m"
        verts = v + signatures[label]
        verts = verts + _smooth_displacement(v, rng, n_modes=8,
                                             scale=deform_scale * bbox / 8)
        if pose:
            theta = rng.uniform(0, 2 * np.pi)
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            k = np.array([[0, -axis[2], axis[1]],
                          [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]])
            rot = np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * (k @ k)
            scale = rng.uniform(0.8, 1.2)
            shift = rng.normal(0, 0.1 * bbox, size=3)
            verts = verts @ rot.T * scale + shift
        name = f"subj{i:04d}_{tag}_synth.obj"
        save_obj(os.path.join(out_dir, name), verts, template.f)
        names.append(name)
    return names
