"""Entry 'fit': litcoder_core_torch.fit_nested_cv on data already on the
device, one fit per job.

params:
  mode          'train_test' (the last `n_test_trs` rows held out, the
                search on chunked inner folds) or 'full_cv' (k-fold
                trimmed outer and inner folds, no test set);
  fit           keyword arguments of fit_nested_cv, passed as they are;
  route         the metrics['solver_paths'] the fit must report;
  rank, n_null, noise_std, uniform_gain
                the planted signal (traffic/signal.py);
  block         voxels per block in the reference.
The configuration gives the rows, the features and the voxels, and the
search (alphas, folds, chunk length).
"""

from typing import Dict

import numpy as np
import torch

from cardbench import compare
from cardbench.metrics import _counts
from cardbench.precision import tf32
from cardbench.reference import folds as ref_folds
from cardbench.reference import ridge as ref_ridge
from cardbench.reference import stats as ref_stats
from cardbench.traffic.signal import signal_problem


def alpha_grid(config: Dict) -> np.ndarray:
    lo, hi, n = config["alphas_logspace"]
    return np.logspace(lo, hi, n).astype(np.float32)


class Job:
    def __init__(self, cell):
        self.cell = cell
        c, p = cell.config, cell.params
        self.mode = p["mode"]
        self.n_train = c["n_train_trs"]
        self.n_test = c.get("n_test_trs", 0)
        self.grid = alpha_grid(c)
        self.block = p["block"]
        self.X, self.Y = signal_problem(
            self.n_train + self.n_test, c["n_features"], c["n_voxels"],
            p["rank"], p["n_null"], cell.seed, cell.device, p["noise_std"],
            p.get("uniform_gain", False))
        self.fit_kwargs = dict(
            p["fit"], alphas=self.grid.tolist(), seed=cell.seed,
            n_inner_folds=c["n_inner_folds"], chunk_length=c["chunk_length"],
            device=cell.device)
        if self.mode == "full_cv":
            self.fit_kwargs["n_outer_folds"] = c["n_outer_folds"]
        self._ref = None
        self._r_cache: Dict[bytes, tuple] = {}
        self.n_perm = (int(p["fit"].get("n_permutations", 1000))
                       if p["fit"].get("significance") == "permutation"
                       else 0)

    def build_seconds(self) -> float:
        return 0.0

    def _inputs(self):
        if self.mode == "train_test":
            n = self.n_train
            return (self.X[:n], self.Y[:n], self.X[n:], self.Y[n:])
        return (self.X, self.Y)

    def run_once(self) -> Dict:
        from litcoder_core_torch import fit_nested_cv

        metrics, _, alphas = fit_nested_cv(*self._inputs(), **self.fit_kwargs)
        if self.cell.device == "cuda":
            torch.cuda.synchronize()
        return {"outputs": {
            "alphas": np.asarray(alphas, np.float32),
            "r": np.asarray(metrics["correlations"], np.float32),
            "p": np.asarray(metrics["p_values"], np.float64),
            "q": np.asarray(metrics["corrected_p_values"], np.float64),
            "route": metrics["solver_paths"]}}

    def release(self) -> None:
        if self.cell.device == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference, and the control in its place ----

    def _folds(self):
        c = self.cell.config
        if self.mode == "train_test":
            return ref_folds.chunked_folds(self.n_train, c["n_inner_folds"],
                                           c["chunk_length"], self.cell.seed)
        return ref_folds.kfold_trimmed(self.n_train, c["n_outer_folds"],
                                       c["trim"])

    def _inner_of(self, n_rows: int):
        c = self.cell.config
        return ref_folds.kfold_trimmed(n_rows, c["n_inner_folds"], c["trim"])

    def reference(self, tf32_on: bool = False) -> Dict:
        """What the plain reference gives: train/test the search's scores
        (and the refit for any alphas, through `r_at`); full-CV the per-fold
        held-out r."""
        single = bool(self.cell.params["fit"].get("single_alpha", False))
        with tf32(tf32_on):
            if self.mode == "train_test":
                Xtr, Ytr, _, _ = self._inputs()
                scores = ref_ridge.search_scores(Xtr, Ytr, self._folds(),
                                                 self.grid, self.block)
                return {"scores": scores.cpu().numpy(),
                        "chosen": ref_ridge.best_alphas(scores, self.grid,
                                                        single)}
            mean_alphas, r_folds, sizes = ref_ridge.full_cv(
                self.X, self.Y, self._folds(), self._inner_of, self.grid,
                self.block, single)
            return {"r_folds": r_folds, "sizes": sizes, "alphas": mean_alphas}

    def r_at(self, alphas: np.ndarray, tf32_on: bool = False):
        """(held-out r, permutation p-values or None) of the reference's
        refit at `alphas`."""
        offsets = (ref_ridge.circular_offsets(self.cell.seed, self.n_perm,
                                              self.n_test)
                   if self.n_perm else None)
        with tf32(tf32_on):
            out = ref_ridge.refit_r(*self._inputs(), alphas, self.block,
                                    offsets)
        if offsets is None:
            return out.cpu().numpy(), None
        return out[0].cpu().numpy(), out[1].cpu().numpy()

    def control_outputs(self) -> Dict:
        """The reference in the program's place, with TF32 on."""
        ref = self.reference(tf32_on=True)
        if self.mode == "train_test":
            r, p = self.r_at(ref["chosen"], tf32_on=True)
            if p is None:
                p = ref_stats.pearson_pvalues(r, self.n_test)
            return {"alphas": ref["chosen"], "r": r, "p": p,
                    "q": ref_stats.bh_adjust(p), "route": None}
        r = ref["r_folds"].mean(axis=0)
        p = ref_stats.fisher_combine(np.stack([
            ref_stats.pearson_pvalues(rf, n)
            for rf, n in zip(ref["r_folds"], ref["sizes"])]))
        return {"alphas": ref["alphas"], "r": r, "p": p,
                "q": ref_stats.bh_adjust(p), "route": None}

    def numbers(self, out: Dict, ref: Dict) -> Dict[str, float]:
        if self.mode == "train_test":
            key = out["alphas"].tobytes()
            if key not in self._r_cache:
                self._r_cache[key] = self.r_at(out["alphas"])
            r_ref, p_perm = self._r_cache[key]
            nums = compare.train_test_numbers(
                out, ref["scores"], self.grid, r_ref, self.n_test, p_perm,
                self.n_perm)
        else:
            nums = compare.full_cv_numbers(out, ref["r_folds"], ref["sizes"])
        if out["route"] is not None:
            nums["route"] = float(out["route"] != self.cell.params["route"])
        return nums

    def flops(self) -> float:
        """Operations of one fit on today's default route (metrics/
        _counts.py)."""
        c = self.cell.config
        a = self.grid.size
        if self.mode == "train_test":
            folds = self._folds()
            return _counts.train_test_flops(
                self.n_train, self.n_test, c["n_features"], c["n_voxels"], a,
                _counts.fold_sizes(folds),
                _counts.covers_all_rows(folds, self.n_train))
        return _counts.full_cv_flops(c["n_features"], c["n_voxels"], a, [
            (len(tr), len(te), _counts.fold_sizes(self._inner_of(len(tr))))
            for tr, te in self._folds()])

    def check(self, record: Dict) -> Dict[str, float]:
        """The numbers of one job of the window."""
        return self.numbers(record["outputs"], self._reference())

    def check_control(self) -> Dict[str, float]:
        """The same numbers of the control (calibrate.py)."""
        return self.numbers(self.control_outputs(), self._reference())

    def _reference(self) -> Dict:
        if self._ref is None:
            self._ref = self.reference()
        return self._ref
