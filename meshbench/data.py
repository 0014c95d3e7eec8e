"""The benchmark's inputs, made from the seed: synthetic meshes, their
alignment and normalisation, and the model's weights.

Meshes follow the arithmetic of the port's synthetic data generator
(meshvae_tpu_torch/data/synthetic.py, copied here so that the yardstick
stays put): the template plus one of two class signatures (smooth cosine
modes, labels alternate 0, 1), a per-mesh smooth displacement and a random
similarity pose. The random numbers are drawn on the host in the
generator's order; the fields are evaluated on the device for all meshes
in a few batched calls, and nothing is written to disk. Each mesh is then
aligned to the template by similarity Procrustes, as the port's dataset
and server do on the host (mesh/procrustes.py), which gives the aligned
vertices and the inverse transform (R, s, m) with original = aligned @ R
* s + m; x is the aligned mesh normalised per vertex by the mean and
standard deviation of the split the statistics are taken from.

Weights are drawn on the device from the seed in two calls (one normal,
one uniform) with the published initialisation: N(0, 0.1) for the
Chebyshev weights and biases and for enc_lin's and dec_lin's weights,
U(+-1/sqrt(fan_in)) for the other linear weights and every linear bias.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's --seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _modes(rng, extent, n_modes, scale):
    """(freq [M, 3], phase [M, 3], amp [M, 3]) drawn as the generator
    draws them, mode by mode."""
    out = []
    for _ in range(n_modes):
        freq = rng.uniform(0.5, 2.0, size=3) / extent
        phase = rng.uniform(0, 2 * np.pi, size=3)
        amp = rng.normal(0, scale, size=3)
        out.append((freq, phase, amp))
    return [np.stack(a) for a in zip(*out)]


def _field(v: torch.Tensor, freq, phase, amp) -> torch.Tensor:
    """sum_m amp[:, m] cos(2 pi (v . freq[:, m]) + phase[:, m]) for a
    batch: v [N, 3]; freq, phase, amp [S, M, 3] -> [S, N, 3]."""
    out = torch.zeros((freq.shape[0],) + tuple(v.shape), dtype=v.dtype,
                      device=v.device)
    for k in range(freq.shape[1]):
        arg = 2 * np.pi * (v @ freq[:, k].T).T              # [S, N]
        out += amp[:, k, None, :] * torch.cos(arg[..., None]
                                              + phase[:, k, None, :])
    return out


def synthetic_meshes(v: np.ndarray, n: int, seed: int, device,
                     deform_scale: float = 0.01, class_scale: float = 0.02,
                     chunk: int = 64) -> dict:
    """n meshes over the template vertices v [N, 3], aligned to it:
    aligned [n, N, 3] float32 and r [n, 3, 3], s [n], m [n, 1, 3] float32
    on the device; label [n] int64 (i % 2)."""
    v = np.asarray(v, dtype=np.float64)
    rng = np.random.default_rng(seed)
    class_rng = np.random.default_rng(seed + 10_000)
    extent = v.max(axis=0) - v.min(axis=0)
    extent[extent == 0] = 1.0
    bbox = float(np.linalg.norm(v.max(0) - v.min(0)))
    signatures = [_modes(class_rng, extent, 6, class_scale * bbox / 6)
                  for _ in range(2)]
    modes, poses = [], []
    for _ in range(n):
        modes.append(_modes(rng, extent, 8, deform_scale * bbox / 8))
        theta = rng.uniform(0, 2 * np.pi)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        rot = np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * (k @ k)
        poses.append((rot, rng.uniform(0.8, 1.2),
                      rng.normal(0, 0.1 * bbox, size=3)))

    dev = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                    device=device)
    vt = dev(v)
    sig = _field(vt, *(dev(np.stack(p)) for p in zip(*signatures)))
    templ = vt - vt.mean(0)
    templ = templ / torch.linalg.norm(templ)
    label = torch.arange(n, device=device) % 2
    aligned = torch.empty((n,) + v.shape, dtype=torch.float32, device=device)
    r_all, s_all, m_all = [], [], []
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        disp = _field(vt, *(dev(np.stack(p)) for p in zip(*modes[lo:hi])))
        verts = vt + sig[label[lo:hi]] + disp
        rot = dev(np.stack([p[0] for p in poses[lo:hi]]))
        scale = dev([p[1] for p in poses[lo:hi]])
        shift = dev(np.stack([p[2] for p in poses[lo:hi]]))
        points = (verts @ rot.transpose(1, 2)) * scale[:, None, None] \
            + shift[:, None, :]
        # similarity Procrustes of each mesh onto the template
        mean2 = points.mean(1, keepdim=True)
        centred = points - mean2
        norm2 = torch.linalg.norm(centred.reshape(hi - lo, -1), dim=1)
        centred = centred / norm2[:, None, None]
        cross = (templ.T[None] @ centred).cpu().numpy()     # [S, 3, 3]
        u, sv, vh = np.linalg.svd(cross)
        r = dev(u @ vh)
        s = dev(sv.sum(-1))
        aligned[lo:hi] = ((centred @ r.transpose(1, 2))
                          * s[:, None, None]).float()
        r_all.append(r.float())
        s_all.append((norm2 / s).float())
        m_all.append(mean2.float())
    return {"aligned": aligned, "r": torch.cat(r_all), "s": torch.cat(s_all),
            "m": torch.cat(m_all), "label": label}


def normalisation(aligned: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Per-vertex mean and standard deviation [N, 3] of a split, in
    float64 over its float32 values, returned as float32."""
    a = aligned.double()
    mean = a.mean(0)
    std = (a - mean).square().mean(0).sqrt()
    return (mean.float().cpu().numpy(), std.float().cpu().numpy())


def normalise(aligned: torch.Tensor, mean, std) -> torch.Tensor:
    dev = aligned.device
    return (aligned - torch.as_tensor(mean, device=dev)) / torch.as_tensor(
        std, device=dev)


def draw_weights(specs: list, seed: int, device) -> dict:
    """name -> float32 tensor on the device for (name, shape, init) specs
    (reference.model.param_specs), in two calls of a generator on the
    device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {name: int(np.prod(shape)) for name, shape, _ in specs}
    normal = [s for s in specs if s[2][0] == "normal"]
    uniform = [s for s in specs if s[2][0] == "uniform"]
    nbuf = torch.empty(sum(sizes[s[0]] for s in normal),
                       device=device).normal_(generator=gen)
    ubuf = torch.empty(sum(sizes[s[0]] for s in uniform),
                       device=device).uniform_(-1.0, 1.0, generator=gen)
    out = {}
    for group, buf in ((normal, nbuf), (uniform, ubuf)):
        offset = 0
        for name, shape, (_, scale) in group:
            n = sizes[name]
            out[name] = (buf[offset:offset + n] * scale).reshape(shape)
            offset += n
    return out
