"""Mesh dataset: listing, Procrustes alignment, normalization, batching
(counterpart of meshvae_tpu/data/dataset.py).

  * ``list_meshes``: sorted .obj listing with outlier rejection from an
    error file and sex labels from the second filename token
    (``x_f_*.obj`` -> 0, ``x_m_*.obj`` -> 1);
  * ``MeshDataset``: eager load, per-sample Procrustes alignment to the
    template with the inverse-transform triple (R, s, m) kept for the
    original-pose error, and per-vertex mean/std of the train split
    written to ``norm.npz``;
  * ``BatchIterator``: fixed-size batches; the last partial batch is padded
    by repeating its last sample and carries a sample ``mask``.

Host side is plain numpy; the trainer moves batches to the device.
"""
from __future__ import annotations

import os

import numpy as np

from ..mesh.io import load_obj
from ..mesh.procrustes import procrustes_align


def list_meshes(config: dict, sex_from_filename: bool = True):
    """Returns (dataset_index: list[str], labels: dict[str, int]). With
    sex_from_filename False (unlabelled data, as batch inference reads it)
    every label is -1."""
    labels: dict[str, int] = {}
    dataset_index: list[str] = []
    root_dir = config.get("root_dir", "")
    if not root_dir or not os.path.isdir(root_dir):
        raise FileNotFoundError(
            f"root_dir {root_dir!r} is not a directory: set it in the config "
            "to a folder of .obj meshes; meshvae_tpu_torch/data/synthetic.py "
            "writes a synthetic one")
    to_remove: set[str] = set()
    error_file = config.get("error_file", "")
    if error_file:
        with open(error_file) as fp:
            for line in fp.read().split("\n"):
                to_remove.add(line.split(" ")[0])

    n_meshes = n_rejected = 0
    for name in sorted(os.listdir(root_dir)):
        if not name.endswith(".obj"):
            continue
        n_meshes += 1
        if name in to_remove:
            n_rejected += 1
            continue
        dataset_index.append(name)
        if sex_from_filename:
            labels[name] = 0 if name.split("_")[1] == "f" else 1
        else:
            labels[name] = -1
    print(f"Dataset : {n_meshes} meshes, {n_rejected} rejected meshes, "
          f"{len(dataset_index)} remaining meshes")
    return dataset_index, labels


class MeshDataset:
    """Eagerly loaded, Procrustes-aligned mesh collection.

    Arrays:
      aligned   [S, N, 3] float32, template-frame vertices (before
                normalization)
      x         [S, N, 3] float32, normalized: (aligned - mean) / std
      labels    [S] int32
      r [S, 3, 3], s [S], m [S, 1, 3]: inverse similarity transforms
      original  [S, N, 3] float32, raw vertices in the original pose

    A "train" dataset computes the per-vertex mean and std and writes them
    to ``checkpoint_dir/norm.npz`` (recomputed per split, as the reference
    does; write_norm=False computes them without writing, on the ranks of
    a world that are not the primary); any other reads them from there."""

    def __init__(self, dataset_index: list[str], config: dict,
                 labels: dict[str, int], template: np.ndarray,
                 dtype: str = "train", write_norm: bool = True):
        self.checkpoint_dir = config["checkpoint_dir"]
        self.root_dir = config["root_dir"]
        self.dtype = dtype
        n = np.asarray(template).shape[0]

        files, label_list = [], []
        aligned_list, orig_list, r_list, s_list, m_list = [], [], [], [], []
        for name in dataset_index:
            path = os.path.join(self.root_dir, name)
            if not os.path.exists(path):
                continue
            points = np.asarray(load_obj(path).v)
            aligned, (r, s, m), _ = procrustes_align(template, points)
            files.append(path)
            label_list.append(labels[name])
            aligned_list.append(aligned.astype(np.float32))
            orig_list.append(points.astype(np.float32))
            r_list.append(r.astype(np.float32))
            s_list.append(np.float32(s))
            m_list.append(m.astype(np.float32))

        self.filenames = files
        self.aligned = (np.stack(aligned_list) if aligned_list
                        else np.zeros((0, n, 3), np.float32))
        self.original = (np.stack(orig_list) if orig_list
                         else self.aligned.copy())
        self.labels = np.asarray(label_list, dtype=np.int32)
        self.r = (np.stack(r_list) if r_list
                  else np.zeros((0, 3, 3), np.float32))
        self.s = np.asarray(s_list, dtype=np.float32)
        self.m = (np.stack(m_list) if m_list
                  else np.zeros((0, 1, 3), np.float32))

        norm_path = os.path.join(self.checkpoint_dir, "norm.npz")
        stats = None
        if dtype == "train":
            mean = self.aligned.astype(np.float64).mean(axis=0)
            std = self.aligned.astype(np.float64).std(axis=0)
            stats = (mean, std)
        if dtype == "train" and write_norm:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            # temp file + rename: a concurrent reader never sees a partial
            # archive (np.savez appends .npz to a suffix-less path)
            tmp_path = norm_path + f".tmp{os.getpid()}.npz"
            np.savez(tmp_path, mean=mean, std=std)
            os.replace(tmp_path, norm_path)

        if stats is None:
            with np.load(norm_path) as norm:
                stats = (norm["mean"], norm["std"])
        self.mean = stats[0].astype(np.float32)
        self.std = stats[1].astype(np.float32)
        self.x = (self.aligned - self.mean) / self.std

        print(f"{dtype} dataset has been created, number of {dtype} samples:",
              len(self.filenames))

    def __len__(self) -> int:
        return len(self.filenames)


class BatchIterator:
    """Fixed-size batches with a padding mask; optional shuffling."""

    def __init__(self, dataset: MeshDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        for start in range(0, n, bs):
            idx = order[start:start + bs]
            pad = bs - idx.shape[0]
            mask = np.ones(bs, dtype=np.float32)
            if pad:
                mask[idx.shape[0]:] = 0.0
                idx = np.concatenate([idx, np.full(pad, idx[-1])])
            yield {
                "x": self.ds.x[idx],
                "label": self.ds.labels[idx],
                "r": self.ds.r[idx],
                "s": self.ds.s[idx],
                "m": self.ds.m[idx],
                "original": self.ds.original[idx],
                "mask": mask,
                "index": idx,
            }

    def __len__(self):
        return -(-len(self.ds) // self.batch_size)
