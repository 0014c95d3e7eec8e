"""Similarity Procrustes alignment (counterpart of
meshvae_tpu/mesh/procrustes.py): a host-side numpy alignment returning the
inverse-transform triple (R, s, m) with ``aligned @ R * s + m`` recovering
the original pose, and its batched torch inverse."""
from __future__ import annotations

import numpy as np
import torch


def _orthogonal_procrustes(a: np.ndarray, b: np.ndarray):
    """R, s minimizing ||a - b R^T||_F over orthogonal R (scipy-compatible:
    returns R with b @ R.T ~ a and s = sum of singular values)."""
    m = a.T @ b
    u, sv, vt = np.linalg.svd(m)
    r = u @ vt
    return r, float(sv.sum())


def procrustes_align(template: np.ndarray, points: np.ndarray):
    """Align points to template (full similarity: translate/scale/rotate).

    Returns:
      aligned: [N, 3] the transformed `points` in template frame.
      inverse: (R [3,3], s scalar, m [1,3]) with
               original = aligned @ R * s + m.
      disparity: sum of squared differences in the normalized frame.
    """
    mtx1 = np.array(template, dtype=np.float64)
    mtx2 = np.array(points, dtype=np.float64)
    if mtx1.shape != mtx2.shape:
        raise ValueError("template/points shape mismatch")

    mean2 = mtx2.mean(axis=0)
    mtx1 = mtx1 - mtx1.mean(axis=0)
    mtx2 = mtx2 - mean2

    norm1 = np.linalg.norm(mtx1)
    norm2 = np.linalg.norm(mtx2)
    if norm1 == 0 or norm2 == 0:
        raise ValueError("degenerate point set")
    mtx1 /= norm1
    mtx2 /= norm2

    r, s = _orthogonal_procrustes(mtx1, mtx2)
    aligned = (mtx2 @ r.T) * s
    disparity = float(np.sum((mtx1 - aligned) ** 2))
    # inverse similarity: x_orig = aligned @ R * (norm2 / s) + mean2
    return aligned, (r, norm2 / s, mean2.reshape(1, 3)), disparity


def apply_inverse_similarity(x: torch.Tensor, r: torch.Tensor,
                             s: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Batched inverse transform: x [B, N, 3] @ R [B, 3, 3] * s [B]
    + m [B, 1, 3]."""
    return torch.bmm(x * s[:, None, None], r) + m
