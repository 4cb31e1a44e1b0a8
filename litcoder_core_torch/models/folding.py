"""Cross-validation folds (twin of litcoder_core_tpu/models/folding.py).

Host numpy only, with no scikit-learn: the chunked schemes make the same
seeded numpy draws as the JAX package, so both packages return identical
splits. Schemes whose splits come from scikit-learn's draws are not ported
yet (ROADMAP queue A) and raise NotImplementedError.
"""

from typing import List, Optional, Tuple

import numpy as np

Fold = Tuple[np.ndarray, np.ndarray]

_NEEDS_SKLEARN = ("chunked_trimmed", "kfold", "kfold_trimmed", "timeseries",
                  "group")


def create_folds(
    n_samples: int,
    fold_type: str,
    n_folds: int,
    chunk_length: Optional[int] = None,
    trim_size: Optional[int] = None,
    groups: Optional[np.ndarray] = None,
    seed: int = 0,
) -> List[Fold]:
    """Train/test index folds; fold_type 'chunked' or 'chunked_contiguous'."""
    if fold_type == "chunked":
        return create_chunked_folds(n_samples, n_folds, chunk_length,
                                    shuffle=True, seed=seed)
    if fold_type == "chunked_contiguous":
        return create_chunked_folds(n_samples, n_folds, chunk_length,
                                    shuffle=False, seed=seed)
    if fold_type in _NEEDS_SKLEARN:
        raise NotImplementedError(
            f"folding_type {fold_type!r} is not ported to litcoder_core_torch "
            "yet (see ROADMAP.md, queue A); use 'chunked' or "
            "'chunked_contiguous'"
        )
    raise ValueError(f"Unknown folding type: {fold_type}")


def _chunks_to_indices(chunks, chunk_length: int, n_samples: int) -> np.ndarray:
    """Expand chunk ids to sample indices, clipping the tail chunk."""
    if len(chunks) == 0:
        return np.array([], dtype=np.int64)
    starts = np.asarray(chunks) * chunk_length
    idx = (starts[:, None] + np.arange(chunk_length)[None, :]).reshape(-1)
    return idx[idx < n_samples]


def create_chunked_folds(n_samples: int, n_folds: int, chunk_length: int,
                         shuffle: bool = True, seed: int = 0) -> List[Fold]:
    """Chunks of `chunk_length` samples dealt into folds, shuffled with
    np.random.default_rng(seed) or contiguous; samples past the last
    complete chunk are unused."""
    n_chunks = n_samples // chunk_length
    chunk_indices = np.arange(n_chunks)
    if shuffle:
        np.random.default_rng(seed).shuffle(chunk_indices)
    per_fold = n_chunks // n_folds
    if per_fold == 0:
        raise NotImplementedError(
            f"{n_chunks} chunks of {chunk_length} cannot fill {n_folds} "
            "folds; the KFold fallback is not ported to litcoder_core_torch "
            "yet (see ROADMAP.md, queue A)"
        )

    splits: List[Fold] = []
    for i in range(n_folds):
        lo = i * per_fold
        hi = (i + 1) * per_fold if i < n_folds - 1 else n_chunks
        test_chunks = chunk_indices[lo:hi]
        train_chunks = np.concatenate([chunk_indices[:lo], chunk_indices[hi:]])
        train_chunks = np.sort(train_chunks) if shuffle else train_chunks
        test_idx = _chunks_to_indices(np.sort(test_chunks), chunk_length,
                                      n_samples)
        train_idx = _chunks_to_indices(train_chunks, chunk_length, n_samples)
        splits.append((train_idx, test_idx))
    return splits
