"""Port parity for models/folding.py: every fold scheme of the port against
the JAX package's create_folds and, for the schemes the JAX package takes
from scikit-learn, against scikit-learn itself, index for index, over
several seeds and sizes with a remainder. The port imports no
scikit-learn."""

import ast
import logging
from pathlib import Path

import numpy as np
import pytest
from sklearn.model_selection import GroupKFold, KFold, TimeSeriesSplit

from litcoder_core_torch.models import folding as tf
from litcoder_core_tpu.models.folding import create_folds as jax_folds

REPO = Path(__file__).resolve().parent.parent
SCHEMES = ["chunked", "chunked_trimmed", "chunked_contiguous", "kfold",
           "kfold_trimmed", "timeseries", "group"]


def _groups(n, seed):
    """Uneven group sizes, so GroupKFold's greedy balancing has ties and
    choices to make."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 9, n) * 3 + rng.integers(0, 2, n)


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, np.asarray(wt))
        np.testing.assert_array_equal(gv, np.asarray(wv))


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("n,n_folds,chunk", [(403, 5, 20), (257, 4, 17),
                                             (120, 3, 10)])
def test_every_scheme_matches_jax(scheme, n, n_folds, chunk):
    for seed in (0, 3, 11):
        groups = _groups(n, seed) if scheme == "group" else None
        got = tf.create_folds(n, scheme, n_folds, chunk, groups=groups,
                              seed=seed)
        want = jax_folds(n, scheme, n_folds, chunk, groups=groups,
                         seed=seed)
        _assert_same(got, want)


@pytest.mark.parametrize("trim", [0, 2, 7])
@pytest.mark.parametrize("scheme", ["chunked_trimmed", "kfold_trimmed"])
def test_trim_sizes_match_jax(scheme, trim):
    for n in (203, 400):
        _assert_same(tf.create_folds(n, scheme, 5, 20, trim_size=trim,
                                     seed=5),
                     jax_folds(n, scheme, 5, 20, trim_size=trim, seed=5))


@pytest.mark.parametrize("form", ["positional", "keyword"])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n,n_folds,chunk,trim", [(100, 5, 10, 2),
                                                  (403, 5, 20, 5),
                                                  (30, 5, 10, 1)])
def test_chunked_trimmed_shuffle_matches_jax(shuffle, form, n, n_folds,
                                             chunk, trim):
    """create_chunked_folds_trimmed has JAX's signature: `shuffle` comes
    before `seed`, so a positional False is the shuffle flag."""
    from litcoder_core_tpu.models.folding import (
        create_chunked_folds_trimmed as jax_trimmed,
    )

    for seed in (0, 3):
        if form == "positional":
            got = tf.create_chunked_folds_trimmed(n, n_folds, chunk, trim,
                                                  shuffle, seed)
            want = jax_trimmed(n, n_folds, chunk, trim, shuffle, seed)
        else:
            got = tf.create_chunked_folds_trimmed(
                n, n_folds, chunk, trim_size=trim, shuffle=shuffle,
                seed=seed)
            want = jax_trimmed(n, n_folds, chunk, trim_size=trim,
                               shuffle=shuffle, seed=seed)
        _assert_same(got, want)
    if (n, shuffle) == (100, False):
        np.testing.assert_array_equal(
            got[0][1], np.r_[np.arange(2, 8), np.arange(12, 18)])


@pytest.mark.parametrize("n,n_folds", [(10, 2), (101, 5), (257, 7),
                                       (64, 8)])
def test_splitters_match_scikit_learn(n, n_folds):
    X = np.zeros((n, 1))
    _assert_same(tf.kfold_splits(n, n_folds),
                 list(KFold(n_splits=n_folds).split(X)))
    _assert_same(tf.timeseries_splits(n, n_folds),
                 list(TimeSeriesSplit(n_splits=n_folds).split(X)))
    for seed in (0, 1, 42):
        _assert_same(tf.kfold_splits(n, n_folds, shuffle=True, seed=seed),
                     list(KFold(n_splits=n_folds, shuffle=True,
                                random_state=seed).split(X)))
        groups = _groups(n, seed)
        if len(np.unique(groups)) >= n_folds:
            _assert_same(tf.group_kfold_splits(groups, n_folds),
                         list(GroupKFold(n_splits=n_folds).split(
                             X, groups=groups)))


def test_group_folds_with_string_labels_match_scikit_learn():
    groups = np.array(["s3", "s1", "s2", "s1", "s3", "s3", "s4", "s2", "s5",
                       "s4", "s1", "s3"])
    _assert_same(tf.create_folds(len(groups), "group", 3, groups=groups),
                 list(GroupKFold(n_splits=3).split(groups, groups=groups)))


@pytest.mark.parametrize("scheme,shuffled", [("chunked", True),
                                              ("chunked_contiguous", False),
                                              ("chunked_trimmed", False)])
def test_too_few_chunks_fall_back_to_kfold(scheme, shuffled, caplog):
    """7 chunks of 20 cannot fill 8 folds: chunked falls back to a KFold
    shuffled with random_state=seed, the other two to an unshuffled one."""
    n, n_folds = 147, 8
    X = np.zeros((n, 1))
    for seed in (0, 9):
        with caplog.at_level(logging.WARNING):
            got = tf.create_folds(n, scheme, n_folds, 20, seed=seed)
        assert "falling back to KFold" in caplog.text
        kf = (KFold(n_splits=n_folds, shuffle=True, random_state=seed)
              if shuffled else KFold(n_splits=n_folds))
        _assert_same(got, list(kf.split(X)))
        _assert_same(got, jax_folds(n, scheme, n_folds, 20, seed=seed))


def test_kfold_trimmed_warns_when_a_fold_is_too_small(caplog):
    with caplog.at_level(logging.WARNING):
        got = tf.create_folds(30, "kfold_trimmed", 3, trim_size=5)
    assert "too small" in caplog.text
    _assert_same(got, jax_folds(30, "kfold_trimmed", 3, trim_size=5))
    assert all(len(te) == 10 for _, te in got)  # left whole


def test_bad_arguments_raise_like_scikit_learn():
    with pytest.raises(ValueError, match="Groups must be provided"):
        tf.create_folds(50, "group", 3)
    with pytest.raises(ValueError, match="Unknown folding type"):
        tf.create_folds(50, "loo", 3)
    with pytest.raises(ValueError):
        tf.kfold_splits(3, 5)
    with pytest.raises(ValueError):
        tf.group_kfold_splits(np.array([0, 0, 1, 1]), 3)
    with pytest.raises(ValueError):
        tf.timeseries_splits(4, 5)


def test_the_port_imports_no_scikit_learn():
    """No module of the port imports scikit-learn, save the wrapper of its
    estimators (models/sklearn_model.py), and that one only inside
    `_sklearn()`, which runs when a SklearnPredictivityModel is built
    (tests/test_torch_package.py checks that importing the port loads no
    scikit-learn)."""
    wrapper = REPO / "litcoder_core_torch" / "models" / "sklearn_model.py"
    for path in (REPO / "litcoder_core_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        lazy = set()
        if path == wrapper:
            (fn,) = [n for n in ast.walk(tree)
                     if isinstance(n, ast.FunctionDef) and n.name == "_sklearn"]
            lazy = {id(n) for n in ast.walk(fn)}
        for node in ast.walk(tree):
            if id(node) in lazy:
                continue
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert all(n.split(".")[0] != "sklearn" for n in names), path
