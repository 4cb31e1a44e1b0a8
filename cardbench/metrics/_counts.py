"""Operations and bytes a cell's work needs, counted from its shapes.

Counted from the sizes and the folds alone, never from the program's own
counters, so the count is the same whatever implements the work. A matrix
product of (m, k) by (k, n) is 2mkn; a Cholesky n^3 / 3; a triangular
solve with m right-hand sides n^2 m; a symmetric eigendecomposition with
vectors 9 n^3; a z-scored correlation 8 operations an element; Lanczos'
largest eigenvalue 64 products with the matrix.

The fit follows today's default route ('auto') at the shapes given:
- the Cholesky search when every inner training block is tall
  (rows >= features), in complement form when the folds cover every row
  (one X^T X and X^T Y, each fold downdated) and in gather form otherwise;
- the dual (kernel) search when the blocks are wide: one K = X X^T, per
  fold a Cholesky of its training block and solves against K_tr,va (or
  against Y_tr when V < T_va);
- the refit: eigh of X^T X when tall, of X X^T when wide, the weights,
  the held-out prediction and its correlation.
"""

from typing import List, Sequence, Tuple

import numpy as np

LANCZOS_STEPS = 64
EIGH = 9.0
SCORE = 8.0
Sizes = List[Tuple[int, int]]        # (training rows, validation rows)


def _search(t: int, d: int, v: int, a: int, folds: Sizes,
            covers_all: bool) -> float:
    tall = all(ttr >= d for ttr, _ in folds)
    f = 0.0
    if tall:
        if covers_all:
            f += 2.0 * t * d * d + 2.0 * t * d * v
        for ttr, tva in folds:
            if covers_all:
                f += 2.0 * tva * d * d + 2.0 * tva * d * v
            else:
                f += 2.0 * ttr * d * d + 2.0 * ttr * d * v
            f += LANCZOS_STEPS * 2.0 * d * d
            f += a * (d ** 3 / 3.0 + 2.0 * d * d * tva)
            f += a * (2.0 * tva * d * v + SCORE * tva * v)
        return f
    f += 2.0 * t * t * d
    for ttr, tva in folds:
        f += LANCZOS_STEPS * 2.0 * ttr * ttr + a * ttr ** 3 / 3.0
        if v < tva:
            f += a * (2.0 * ttr * ttr * v + 2.0 * tva * ttr * v)
        else:
            f += a * (2.0 * ttr * ttr * tva + 2.0 * tva * ttr * v)
        f += a * SCORE * tva * v
    return f


def _refit(t: int, t_test: int, d: int, v: int) -> float:
    if t >= d:
        f = 2.0 * t * d * d + EIGH * d ** 3
        f += 2.0 * t * d * v + 2.0 * d * d * v + 2.0 * d * d * v
    else:
        f = 2.0 * t * t * d + EIGH * t ** 3 + 2.0 * t * t * d
        f += 2.0 * t * t * v + 2.0 * d * t * v
    return f + 2.0 * t_test * d * v + SCORE * t_test * v


def train_test_flops(t: int, t_test: int, d: int, v: int, a: int,
                     folds: Sizes, covers_all: bool) -> float:
    return _search(t, d, v, a, folds, covers_all) + _refit(t, t_test, d, v)


def full_cv_flops(d: int, v: int, a: int,
                  outer: Sequence[Tuple[int, int, Sizes]]) -> float:
    """outer: (training rows, test rows, inner fold sizes) per outer fold,
    each fitted on its gathered rows (the per-fold route)."""
    return sum(_search(ttr, d, v, a, inner, False) + _refit(ttr, tte, d, v)
               for ttr, tte, inner in outer)


def fold_sizes(folds) -> Sizes:
    return [(len(tr), len(va)) for tr, va in folds]


def covers_all_rows(folds, n_rows: int) -> bool:
    return all(np.array_equal(np.sort(np.concatenate([tr, va])),
                              np.arange(n_rows)) for tr, va in folds)


def lm_tokens(windows: List[List[int]]) -> List[int]:
    """Lengths of the sequences a causal model must run: a run of windows
    each a token prefix of the next needs only its last window's."""
    lengths, i = [], 0
    while i < len(windows):
        j = i
        while (j + 1 < len(windows)
               and windows[j + 1][:len(windows[j])] == windows[j]):
            j += 1
        lengths.append(len(windows[j]))
        i = j + 1
    return lengths


def lm_flops(windows: List[List[int]], n_embd: int, n_layer: int) -> float:
    """2 x non-embedding parameters x tokens, plus causal attention
    (QK^T and AV over the L (L + 1) / 2 allowed pairs, each layer)."""
    d = n_embd
    params = n_layer * (12 * d * d + 13 * d) + 2 * d
    lengths = np.asarray(lm_tokens(windows), np.float64)
    return float(2.0 * params * lengths.sum()
                 + n_layer * 2.0 * d * (lengths * (lengths + 1)).sum())


def lanczos_fir_counts(nonzero_weights: int, n_words: int, n_tr: int,
                       dim: int, n_delays: int) -> Tuple[float, float]:
    """(bytes, operations) of one fused Lanczos + FIR launch: each input
    byte read once (features, word times, TR times), each output byte
    written once, 2 operations per nonzero weight and feature column."""
    n_bytes = 4.0 * (n_words * dim + n_words + n_tr + n_tr * n_delays * dim)
    return n_bytes, 2.0 * nonzero_weights * dim
