"""Cross-validation folds, written from their definitions.

- chunked: the rows cut into chunks of `chunk_length` (a tail shorter than
  a chunk is in no fold), the chunk order shuffled by
  numpy.random.default_rng(seed), consecutive runs of n_chunks // n_folds
  chunks as the validation sets (the last fold takes the rest), every other
  chunk for training, both in ascending row order.
- kfold_trimmed: contiguous k-fold (the first n % k folds one row longer);
  `trim` rows cut from each end of a test block that is longer than 2 trim.
"""

from typing import List, Tuple

import numpy as np

Fold = Tuple[np.ndarray, np.ndarray]


def chunked_folds(n_rows: int, n_folds: int, chunk_length: int,
                  seed: int) -> List[Fold]:
    n_chunks = n_rows // chunk_length
    order = np.arange(n_chunks)
    np.random.default_rng(seed).shuffle(order)
    per_fold = n_chunks // n_folds
    if per_fold == 0:
        raise ValueError("too few chunks for the folds")

    def rows(chunks):
        chunks = np.sort(np.asarray(chunks, dtype=np.int64))
        return (chunks[:, None] * chunk_length
                + np.arange(chunk_length)[None, :]).reshape(-1)

    folds = []
    for i in range(n_folds):
        lo = i * per_fold
        hi = n_chunks if i == n_folds - 1 else lo + per_fold
        val = order[lo:hi]
        train = np.concatenate([order[:lo], order[hi:]])
        folds.append((rows(train), rows(val)))
    return folds


def kfold_trimmed(n_rows: int, n_folds: int, trim: int = 5) -> List[Fold]:
    sizes = np.full(n_folds, n_rows // n_folds)
    sizes[: n_rows % n_folds] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    folds = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        train = np.concatenate([np.arange(0, lo), np.arange(hi, n_rows)])
        test = np.arange(lo, hi)
        if len(test) > 2 * trim:
            test = test[trim:len(test) - trim]
        folds.append((train, test))
    return folds
