"""The operation and byte counts against counts made by hand."""

import numpy as np
import torch

from cardbench.metrics import _counts
from cardbench.reference import folds


def test_lm_tokens_follow_prefix_runs():
    windows = [[1], [1, 2], [1, 2, 3], [2, 3, 4], [5]]
    assert _counts.lm_tokens(windows) == [3, 3, 1]


def test_lm_flops_by_hand():
    # d = 2, one layer: 12 d^2 + 13 d = 74 parameters in the block, 2 d = 4
    # in the final norm; one sequence of 2 tokens: 2 * 78 * 2 = 312, and
    # causal attention 2 d L (L + 1) = 2 * 2 * 2 * 3 = 24.
    assert _counts.lm_flops([[7], [7, 8]], n_embd=2, n_layer=1) == 336.0


def test_lanczos_fir_counts_by_hand():
    # 10 words x 3 columns, 4 TRs, 2 delays: (30 + 10 + 4 + 4 * 2 * 3) * 4
    # bytes; 7 nonzero weights x 3 columns x 2 operations.
    assert _counts.lanczos_fir_counts(7, 10, 4, 3, 2) == (272.0, 42.0)


def test_train_test_flops_tall_complement_by_hand():
    # t 4 rows, d 2, v 3 voxels, a 1 alpha, two folds of (2 train, 2 val)
    # that cover every row, 2 test rows.
    t, d, v, a = 4, 2, 3, 1
    search = 2 * t * d * d + 2 * t * d * v            # 32 + 48
    fold = (2 * 2 * d * d + 2 * 2 * d * v              # 16 + 24
            + 64 * 2 * d * d                           # Lanczos: 512
            + a * (d ** 3 / 3 + 2 * d * d * 2)         # 8/3 + 16
            + a * (2 * 2 * d * v + 8 * 2 * v))         # 24 + 48
    refit = (2 * t * d * d + 9 * d ** 3 + 2 * t * d * v + 4 * d * d * v
             + 2 * 2 * d * v + 8 * 2 * v)
    want = search + 2 * fold + refit
    got = _counts.train_test_flops(4, 2, 2, 3, 1, [(2, 2), (2, 2)], True)
    assert abs(got - want) < 1e-9


def test_dual_route_when_folds_are_wide():
    # d 10 > 4 training rows: K (t^2 d), per fold Lanczos on 4 x 4, a
    # Cholesky, solves against K_tr,va and the predictions; the refit on
    # the 6 x 6 kernel.
    t, d, v = 6, 10, 5
    got = _counts.train_test_flops(t, 3, d, v, 1, [(4, 2)], False)
    fold = 64 * 2 * 16 + 64 / 3 + 2 * 16 * 2 + 2 * 2 * 4 * v + 8 * 2 * v
    refit = (2 * 36 * d + 9 * 216 + 2 * 36 * d + 2 * 36 * v + 2 * d * t * v
             + 2 * 3 * d * v + 8 * 3 * v)
    assert abs(got - (2 * t * t * d + fold + refit)) < 1e-9


def test_covers_all_rows():
    f = folds.chunked_folds(100, 5, 20, seed=3)
    assert _counts.covers_all_rows(f, 100)
    assert not _counts.covers_all_rows(folds.chunked_folds(110, 5, 20, 3),
                                       110)


def test_reference_folds_match_the_definition():
    f = folds.chunked_folds(100, 2, 10, seed=0)
    order = np.arange(10)
    np.random.default_rng(0).shuffle(order)
    val = np.sort(order[:5])
    assert np.array_equal(f[0][1], (val[:, None] * 10 + np.arange(10))
                          .reshape(-1))
    k = folds.kfold_trimmed(23, 5, trim=1)
    assert [len(te) for _, te in k] == [3, 3, 3, 2, 2]   # 5, 5, 5, 4, 4 less 2
    assert k[0][1].tolist() == [1, 2, 3]


def test_lanczos_matrix_rows_weigh_nearby_words():
    from cardbench.reference.lanczos_fir import lanczos_matrix
    K = lanczos_matrix(torch.tensor([0.0, 1.0, 2.0, 50.0]),
                       torch.tensor([1.0, 3.0, 5.0]))
    assert K[0, 1] == 1.0 and K[0, 3] == 0.0
