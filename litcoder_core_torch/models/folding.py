"""Cross-validation folds (twin of litcoder_core_tpu/models/folding.py).

Host numpy only, with no scikit-learn: all seven schemes of the JAX package.
The chunked schemes make the same seeded numpy draws as the JAX package; the
schemes (and the few-chunks fallbacks) that the JAX package takes from
scikit-learn's KFold, TimeSeriesSplit and GroupKFold are rewritten here
index for index, shuffled KFold's np.random.RandomState draw included.
"""

import logging
from typing import Iterator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

Fold = Tuple[np.ndarray, np.ndarray]


def create_folds(
    n_samples: int,
    fold_type: str,
    n_folds: int,
    chunk_length: Optional[int] = None,
    trim_size: Optional[int] = None,
    groups: Optional[np.ndarray] = None,
    seed: int = 0,
) -> List[Fold]:
    """Train/test index folds. fold_type in {'chunked', 'chunked_trimmed',
    'chunked_contiguous', 'kfold', 'kfold_trimmed', 'timeseries', 'group'}."""
    if fold_type == "chunked":
        return create_chunked_folds(n_samples, n_folds, chunk_length,
                                    shuffle=True, seed=seed)
    if fold_type == "chunked_trimmed":
        return create_chunked_folds_trimmed(
            n_samples, n_folds, chunk_length,
            trim_size=5 if trim_size is None else trim_size, seed=seed)
    if fold_type == "chunked_contiguous":
        return create_chunked_folds(n_samples, n_folds, chunk_length,
                                    shuffle=False, seed=seed)
    if fold_type == "kfold":
        return kfold_splits(n_samples, n_folds)
    if fold_type == "kfold_trimmed":
        return create_kfold_trimmed(n_samples, n_folds,
                                    5 if trim_size is None else trim_size)
    if fold_type == "timeseries":
        return timeseries_splits(n_samples, n_folds)
    if fold_type == "group":
        if groups is None:
            raise ValueError("Groups must be provided for group folding")
        return group_kfold_splits(groups, n_folds)
    raise ValueError(f"Unknown folding type: {fold_type}")


# --- scikit-learn's splitters, index for index -------------------------------


def _splits_from_test_sets(n_samples: int,
                           test_sets: Iterator[np.ndarray]) -> List[Fold]:
    """scikit-learn's BaseCrossValidator.split: each test set becomes a mask,
    so both index arrays come out ascending."""
    indices = np.arange(n_samples)
    splits = []
    for test in test_sets:
        mask = np.zeros(n_samples, dtype=bool)
        mask[test] = True
        splits.append((indices[~mask], indices[mask]))
    return splits


def kfold_splits(n_samples: int, n_folds: int, shuffle: bool = False,
                 seed: Optional[int] = None) -> List[Fold]:
    """sklearn.model_selection.KFold(n_folds, shuffle=shuffle,
    random_state=seed).split(range(n_samples)): the first n_samples %
    n_folds folds hold one sample more; shuffling draws from
    np.random.RandomState(seed)."""
    if n_folds < 2:
        raise ValueError(f"k-fold cross-validation requires at least one "
                         f"train/test split by setting n_splits=2 or more, "
                         f"got n_splits={n_folds}.")
    if n_folds > n_samples:
        raise ValueError(f"Cannot have number of splits n_splits={n_folds} "
                         f"greater than the number of samples: "
                         f"n_samples={n_samples}.")
    indices = np.arange(n_samples)
    if shuffle:
        np.random.RandomState(seed).shuffle(indices)
    sizes = np.full(n_folds, n_samples // n_folds, dtype=int)
    sizes[: n_samples % n_folds] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return _splits_from_test_sets(
        n_samples, (indices[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])))


def timeseries_splits(n_samples: int, n_folds: int) -> List[Fold]:
    """sklearn.model_selection.TimeSeriesSplit(n_folds): test blocks of
    n_samples // (n_folds + 1) at the end, each trained on all before it."""
    test_size = n_samples // (n_folds + 1)
    if n_folds + 1 > n_samples:
        raise ValueError(f"Cannot have number of folds={n_folds + 1} greater"
                         f" than the number of samples={n_samples}.")
    if n_samples - test_size * n_folds <= 0:
        raise ValueError(f"Too many splits={n_folds} for number of samples"
                         f"={n_samples} with test_size={test_size} and gap=0.")
    indices = np.arange(n_samples)
    return [(indices[:start], indices[start:start + test_size])
            for start in range(n_samples - n_folds * test_size, n_samples,
                               test_size)]


def group_kfold_splits(groups, n_folds: int) -> List[Fold]:
    """sklearn.model_selection.GroupKFold(n_folds) (shuffle=False): groups
    in descending size (ties: the later group first) each go to the fold
    with the fewest samples so far (ties: the first such fold)."""
    groups = np.asarray(groups)
    unique_groups, group_idx = np.unique(groups, return_inverse=True)
    group_idx = group_idx.reshape(-1)
    if n_folds > len(unique_groups):
        raise ValueError(f"Cannot have number of splits n_splits={n_folds} "
                         f"greater than the number of groups: "
                         f"{len(unique_groups)}.")
    sizes = np.bincount(group_idx)
    order = np.argsort(sizes, kind="stable")[::-1]
    fold_load = np.zeros(n_folds)
    group_to_fold = np.zeros(len(unique_groups), dtype=int)
    for g in order:
        lightest = int(np.argmin(fold_load))
        fold_load[lightest] += sizes[g]
        group_to_fold[g] = lightest
    sample_fold = group_to_fold[group_idx]
    return _splits_from_test_sets(
        len(groups), (np.nonzero(sample_fold == f)[0] for f in range(n_folds)))


# --- chunked schemes ---------------------------------------------------------


def _chunk_assignment(n_samples: int, n_folds: int, chunk_length: int,
                      shuffle: bool, seed: int):
    """(chunk order, number of chunks, chunks per fold), or None when there
    are too few chunks for the folds (the caller falls back to KFold)."""
    n_chunks = n_samples // chunk_length
    chunk_indices = np.arange(n_chunks)
    if shuffle:
        np.random.default_rng(seed).shuffle(chunk_indices)
    per_fold = n_chunks // n_folds
    if per_fold == 0:
        return None
    return chunk_indices, n_chunks, per_fold


def _chunks_to_indices(chunks, chunk_length: int, n_samples: int) -> np.ndarray:
    """Expand chunk ids to sample indices, clipping the tail chunk."""
    if len(chunks) == 0:
        return np.array([], dtype=np.int64)
    starts = np.asarray(chunks) * chunk_length
    idx = (starts[:, None] + np.arange(chunk_length)[None, :]).reshape(-1)
    return idx[idx < n_samples]


def _fold_chunks(chunk_indices, n_chunks: int, per_fold: int, i: int,
                 n_folds: int):
    """(test chunks, train chunks) of fold i; the last fold takes the rest."""
    lo = i * per_fold
    hi = (i + 1) * per_fold if i < n_folds - 1 else n_chunks
    return (chunk_indices[lo:hi],
            np.concatenate([chunk_indices[:lo], chunk_indices[hi:]]))


def create_chunked_folds(n_samples: int, n_folds: int, chunk_length: int,
                         shuffle: bool = True, seed: int = 0) -> List[Fold]:
    """Chunks of `chunk_length` samples dealt into folds, shuffled with
    np.random.default_rng(seed) or contiguous; samples past the last
    complete chunk are unused. Too few chunks: KFold, shuffled with
    random_state=seed when `shuffle`."""
    assignment = _chunk_assignment(n_samples, n_folds, chunk_length, shuffle,
                                   seed)
    if assignment is None:
        logger.warning(
            "Not enough chunks for the requested folds, falling back to KFold")
        return kfold_splits(n_samples, n_folds, shuffle=shuffle,
                            seed=seed if shuffle else None)
    chunk_indices, n_chunks, per_fold = assignment
    splits: List[Fold] = []
    for i in range(n_folds):
        test_chunks, train_chunks = _fold_chunks(chunk_indices, n_chunks,
                                                 per_fold, i, n_folds)
        train_chunks = np.sort(train_chunks) if shuffle else train_chunks
        test_idx = _chunks_to_indices(np.sort(test_chunks), chunk_length,
                                      n_samples)
        train_idx = _chunks_to_indices(train_chunks, chunk_length, n_samples)
        splits.append((train_idx, test_idx))
    return splits


def create_chunked_folds_trimmed(n_samples: int, n_folds: int,
                                 chunk_length: int, trim_size: int = 5,
                                 shuffle: bool = True,
                                 seed: int = 0) -> List[Fold]:
    """Chunked folds (shuffled with np.random.default_rng(seed), or
    contiguous) with `trim_size` samples cut from each end of every test
    chunk; train chunks stay whole. Too few chunks: unshuffled KFold."""
    assignment = _chunk_assignment(n_samples, n_folds, chunk_length, shuffle,
                                   seed)
    if assignment is None:
        logger.warning(
            "Not enough chunks for the requested folds, falling back to KFold")
        return kfold_splits(n_samples, n_folds)
    chunk_indices, n_chunks, per_fold = assignment
    splits: List[Fold] = []
    for i in range(n_folds):
        test_chunks, train_chunks = _fold_chunks(chunk_indices, n_chunks,
                                                 per_fold, i, n_folds)
        test_parts = []
        for chunk in np.sort(test_chunks):
            start = chunk * chunk_length
            end = min(start + chunk_length, n_samples)
            if start + trim_size < end - trim_size:
                test_parts.append(np.arange(start + trim_size,
                                            end - trim_size))
        test_idx = (np.concatenate(test_parts) if test_parts
                    else np.array([], dtype=np.int64))
        train_idx = _chunks_to_indices(np.sort(train_chunks), chunk_length,
                                       n_samples)
        splits.append((train_idx, test_idx))
    return splits


def create_kfold_trimmed(n_samples: int, n_folds: int,
                         trim_size: int = 5) -> List[Fold]:
    """Contiguous KFold with `trim_size` samples cut from each end of every
    test fold (left whole, with a warning, when it is too small)."""
    splits: List[Fold] = []
    for train_idx, test_idx in kfold_splits(n_samples, n_folds):
        if len(test_idx) > 2 * trim_size:
            test_idx = test_idx[trim_size:-trim_size]
        else:
            logger.warning(
                "Test fold too small (%d samples) to trim %d from each end",
                len(test_idx), trim_size)
        splits.append((train_idx, test_idx))
    return splits
