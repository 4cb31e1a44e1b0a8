"""A whole run but the look for a card, with the timed path broken
underneath: `correct` has to come out false for each fault a cell can
have. (A one-card fit or train() has no state stepped from job to job and
no exchange between cards.)"""

import numpy as np
import pytest
import torch

from cardbench import harness
from cardbench.tests.tiny import SEED, TINY


def run(cell):
    return harness.run_cell(cell, SEED, 0.1, False, device="cpu",
                            overrides=TINY[cell], log=lambda m: None)


def shifted_alphas(select):
    """The alpha search's picks moved one step along the grid."""
    def wrapped(mean_corrs, alphas, single_alpha):
        picks = select(mean_corrs, alphas, single_alpha)
        grid = np.asarray(alphas, np.float32)
        return grid[(np.searchsorted(grid, picks) + 1) % grid.size]
    return wrapped


def altered_r(pearson_r):
    """One voxel's held-out r altered where it is produced."""
    def wrapped(y, pred, *a, **k):
        r = pearson_r(y, pred, *a, **k).clone()
        r[0] += 1e-3
        return r
    return wrapped


def half_the_rows(pearson_r):
    """Half of the held-out rows left out, the correlation taken over the
    rest."""
    def wrapped(y, pred, *a, **k):
        n = y.shape[0] // 2
        return pearson_r(y[:n], pred[:n], *a, **k)
    return wrapped


def altered_null(permutation_pvalues):
    """One voxel's permutation p-value and r altered where produced."""
    def wrapped(y, pred, offsets, *a, **k):
        p, obs = permutation_pvalues(y, pred, offsets, *a, **k)
        p, obs = p.clone(), obs.clone()
        p[0] = 1.0 - p[0]
        obs[0] += 1e-3
        return p, obs
    return wrapped


def half_the_null_rows(permutation_pvalues):
    def wrapped(y, pred, offsets, *a, **k):
        n = y.shape[0] // 2
        return permutation_pvalues(y[:n], pred[:n], offsets % n, *a, **k)
    return wrapped


FIT_FAULTS = {
    "alpha_picks_shifted": ("_select_best_alphas", shifted_alphas),
    "answer_altered": ("pearson_r", altered_r),
    "half_the_batch": ("pearson_r", half_the_rows),
}
PERM_FAULTS = {
    "alpha_picks_shifted": ("_select_best_alphas", shifted_alphas),
    "answer_altered": ("permutation_pvalues", altered_null),
    "half_the_batch": ("permutation_pvalues", half_the_null_rows),
}
CASES = ([(c, f, FIT_FAULTS[f]) for c in ("lebel.fit", "narratives.fit",
                                           "lebel.train_lm")
          for f in sorted(FIT_FAULTS)]
         + [("lebel.fit_chunked_perm", f, PERM_FAULTS[f])
            for f in sorted(PERM_FAULTS)])


@pytest.mark.parametrize("cell,fault,patch", CASES,
                         ids=[f"{c}-{f}" for c, f, _ in CASES])
def test_fit_faults_are_caught(cell, fault, patch, monkeypatch):
    from litcoder_core_torch.models import nested_cv
    name, make = patch
    monkeypatch.setattr(nested_cv, name, make(getattr(nested_cv, name)))
    assert not run(cell)["correct"]


def test_token_altered_is_caught(monkeypatch):
    from litcoder_core_torch.features import language_model as lm
    encode = lm.LanguageModelFeatureExtractor._encode

    def altered(self, text):
        ids = encode(self, text)
        return ids[:-1] + [ids[-1] + 1]

    monkeypatch.setattr(lm.LanguageModelFeatureExtractor, "_encode", altered)
    assert not run("lebel.train_lm")["correct"]


def test_half_the_lm_batch_left_out_is_caught(monkeypatch):
    from litcoder_core_torch.features import language_model as lm
    hidden = lm.LanguageModelFeatureExtractor._hidden_states

    def half(self, ids, mask):
        states = hidden(self, ids, mask)
        n = ids.shape[0] // 2
        return tuple(torch.cat([h[:max(n, 1)], torch.zeros_like(
            h[max(n, 1):])]) for h in states)

    monkeypatch.setattr(lm.LanguageModelFeatureExtractor, "_hidden_states",
                        half)
    assert not run("lebel.train_lm")["correct"]


def test_sound_runs_pass():
    for cell in TINY:
        assert run(cell)["correct"], cell
