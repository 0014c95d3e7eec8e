"""The k-fold and train/validation splits of the train driver, in numpy
(the JAX driver calls scikit-learn, which the port does not depend on).

``stratified_kfold`` yields what ``RepeatedStratifiedKFold(n_splits,
n_repeats=1, random_state=seed).split(X, y)`` yields, and
``train_test_split`` returns what ``sklearn.model_selection.train_test_split
(array, test_size=..., random_state=seed)`` returns for one array: the same
``np.random.RandomState`` streams consumed in the same order
(tests/test_torch_driver.py holds both equal to scikit-learn's).
"""
from __future__ import annotations

import math

import numpy as np


def stratified_kfold(n_splits: int, y, seed: int):
    """(train_index, test_index) per fold: within each class (in order of
    first appearance) the fold sizes are dealt round-robin over the sorted
    labels, and each class's fold assignment is shuffled by one
    RandomState(seed) stream shared across classes."""
    rng = np.random.RandomState(seed)
    y = np.asarray(y).reshape(-1)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    if np.all(n_splits > np.bincount(y_encoded)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         "number of members in each class")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits],
                                         minlength=n_classes)
                             for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(len(y))
    for i in range(n_splits):
        test = test_folds == i
        yield indices[~test], indices[test]


def train_test_split(array, test_size: float, seed: int):
    """(train, test) rows of `array`: ceil(test_size * n) test rows from
    one RandomState(seed) permutation, the rest train."""
    array = np.asarray(array)
    n = len(array)
    n_test = math.ceil(test_size * n)
    if not 0 < n_test < n:
        raise ValueError(f"test_size {test_size} leaves an empty split of "
                         f"{n} samples")
    perm = np.random.RandomState(seed).permutation(n)
    return array[perm[n_test:]], array[perm[:n_test]]
