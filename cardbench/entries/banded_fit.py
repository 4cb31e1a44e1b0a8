"""Entry 'banded_fit': litcoder_core_torch.models.banded.fit_banded_ridge
on data already on the device, one fit per job.

params:
  widths        the bands' widths (the design's column blocks, in order);
  ranks, gains  per band: the planted signal's rank and its gain;
  n_gammas      gamma candidates (sample_gammas, seeded with the cell's
                seed);
  n_null, noise_std
                voxels with no signal; the noise's scale;
  fit           keyword arguments of fit_banded_ridge, passed as they are;
  route         the metrics['solver_paths'] the fit must report;
  block         voxels per block in the reference;
  n_voxels      the voxels fitted, where fewer than the configuration's.
The configuration gives the rows (and the voxels) and the search (alphas,
folds, chunk length).

The responses are the sum over bands of each band's planted signal (the
LeBel fit cells' generator, traffic/signal.py, with U(0, 1) gains per
voxel and its own seed per band) times the band's gain, plus unit noise;
the bands' designs are that generator's standard normal X.
"""

from typing import Dict

import numpy as np
import torch

from cardbench import compare
from cardbench.entries.fit import alpha_grid
from cardbench.metrics._counts import LANCZOS_STEPS, SCORE
from cardbench.precision import tf32
from cardbench.reference import banded as ref_banded
from cardbench.reference import folds as ref_folds
from cardbench.reference import stats as ref_stats
from cardbench.traffic.signal import signal_problem


class Job:
    def __init__(self, cell):
        self.cell = cell
        c, p = cell.config, cell.params
        dev = torch.device(cell.device)
        self.dev = dev
        self.n_train, self.n_test = c["n_train_trs"], c["n_test_trs"]
        rows = self.n_train + self.n_test
        self.n_voxels = v = p.get("n_voxels", c["n_voxels"])
        self.widths = list(p["widths"])
        self.grid = alpha_grid(c)
        self.block = p["block"]
        self.gammas = ref_banded.sample_gammas(len(self.widths),
                                               p["n_gammas"], cell.seed)
        bands, Y = [], None
        for b, (w, rank, gain) in enumerate(zip(self.widths, p["ranks"],
                                                p["gains"])):
            X_b, Y_b = signal_problem(rows, w, v, rank, p["n_null"],
                                      int(cell.seed) + b, dev, 0.0, True)
            bands.append(X_b)
            if Y is None:
                Y = Y_b.mul_(gain)
            else:
                Y.add_(Y_b, alpha=gain)
            del Y_b
        gen = torch.Generator(device=dev).manual_seed(int(cell.seed) - 1)
        for lo in range(0, rows, 4096):
            hi = min(lo + 4096, rows)
            Y[lo:hi].add_(torch.randn((hi - lo, v), device=dev,
                                      generator=gen), alpha=p["noise_std"])
        self.bands, self.Y = bands, Y
        self.X = torch.cat(bands, dim=1)
        self.fit_kwargs = dict(
            p["fit"], alphas=self.grid.tolist(), n_gammas=p["n_gammas"],
            seed=cell.seed, n_inner_folds=c["n_inner_folds"],
            chunk_length=c["chunk_length"], device=cell.device)
        self._ref = None
        self._r_cache: Dict[bytes, np.ndarray] = {}

    def build_seconds(self) -> float:
        return 0.0

    def run_once(self) -> Dict:
        from litcoder_core_torch.models.banded import fit_banded_ridge

        n = self.n_train
        metrics, _, alphas, gammas = fit_banded_ridge(
            [X[:n] for X in self.bands], self.Y[:n],
            X_tests=[X[n:] for X in self.bands], y_test=self.Y[n:],
            **self.fit_kwargs)
        if self.cell.device == "cuda":
            torch.cuda.synchronize()
        return {"outputs": {
            "alphas": np.asarray(alphas, np.float32),
            "gammas": np.asarray(gammas, np.float32),
            "r": np.asarray(metrics["correlations"], np.float32),
            "p": np.asarray(metrics["p_values"], np.float64),
            "q": np.asarray(metrics["corrected_p_values"], np.float64),
            "route": metrics["solver_paths"]}}

    def release(self) -> None:
        self.bands = None
        if self.cell.device == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference, and the control in its place ----

    def _split(self):
        n = self.n_train
        return self.X[:n], self.Y[:n], self.X[n:], self.Y[n:]

    def _folds(self):
        c = self.cell.config
        return ref_folds.chunked_folds(self.n_train, c["n_inner_folds"],
                                       c["chunk_length"], self.cell.seed)

    def reference(self, tf32_on: bool = False) -> Dict:
        X, Y, _, _ = self._split()
        with tf32(tf32_on):
            scores = ref_banded.search_scores(X, Y, self.widths, self.gammas,
                                              self._folds(), self.grid,
                                              self.block)
        return {"scores": scores.cpu().numpy(),
                "pairs": ref_banded.best_pairs(scores)}

    def r_at(self, g_idx, a_idx, tf32_on: bool = False) -> np.ndarray:
        with tf32(tf32_on):
            return ref_banded.refit_r(*self._split(), self.widths,
                                      self.gammas, g_idx, a_idx, self.grid,
                                      self.block).cpu().numpy()

    def control_outputs(self) -> Dict:
        """The reference in the program's place, with TF32 on."""
        ref = self.reference(tf32_on=True)
        g_idx, a_idx = ref["pairs"]
        r = self.r_at(g_idx, a_idx, tf32_on=True)
        p = ref_stats.pearson_pvalues(r, self.n_test)
        return {"alphas": self.grid[a_idx], "gammas": self.gammas[g_idx],
                "r": r, "p": p, "q": ref_stats.bh_adjust(p), "route": None}

    def _pair_index(self, out: Dict):
        """(gamma index, alpha index) of each voxel's produced pair, or
        None where one is not a candidate."""
        a_idx = np.searchsorted(self.grid, out["alphas"])
        a_idx = np.clip(a_idx, 0, self.grid.size - 1)
        match = (out["gammas"][:, None, :] == self.gammas[None]).all(-1)
        if (not np.array_equal(self.grid[a_idx], out["alphas"])
                or not match.any(1).all()):
            return None
        return match.argmax(1), a_idx

    def numbers(self, out: Dict, ref: Dict) -> Dict[str, float]:
        """score_regret over the joint (gamma, alpha) scores; r_gap, p_gap
        and q_gap against the reference's refit at the produced pairs."""
        pairs = self._pair_index(out)
        if pairs is None:
            return {"route": 1.0}
        g_idx, a_idx = pairs
        scores = ref["scores"]
        v = np.arange(scores.shape[2])
        best = scores.reshape(-1, scores.shape[2]).max(0)
        nums = {"score_regret": float(np.max(best - scores[g_idx, a_idx,
                                                           v]))}
        key = g_idx.tobytes() + a_idx.tobytes()
        if key not in self._r_cache:
            self._r_cache[key] = self.r_at(g_idx, a_idx)
        r_ref = self._r_cache[key]
        p_ref = ref_stats.pearson_pvalues(r_ref, self.n_test)
        nums.update(r_gap=compare.widest_gap(out["r"], r_ref),
                    p_gap=compare.widest_gap(out["p"], p_ref),
                    q_gap=compare.widest_gap(out["q"],
                                             ref_stats.bh_adjust(p_ref)))
        if out["route"] is not None:
            nums["route"] = float(out["route"] != self.cell.params["route"])
        return nums

    def check(self, record: Dict) -> Dict[str, float]:
        return self.numbers(record["outputs"], self._reference())

    def check_control(self) -> Dict[str, float]:
        return self.numbers(self.control_outputs(), self._reference())

    def _reference(self) -> Dict:
        if self._ref is None:
            self._ref = self.reference()
        return self._ref

    def flops(self) -> float:
        """Operations of one fit on the route 'auto' takes at these shapes
        (a tall design whose folds cover every row: the Cholesky scan in
        complement form and the grouped Cholesky refit): X^T X and X^T Y
        once; per fold the downdates by its validation rows; per fold and
        gamma the largest eigenvalue (Lanczos) and per alpha a Cholesky,
        the solve factors of the validation rows, their predictions and
        scores; then X^T Y again for the refit, per gamma its largest
        eigenvalue and per (gamma, alpha) a Cholesky and the test rows'
        solve factors, the test predictions and their correlations."""
        c = self.cell.config
        t, t_te, v = self.n_train, self.n_test, self.n_voxels
        d = sum(self.widths)
        g, a = len(self.gammas), self.grid.size
        f = 2.0 * t * d * d + 2.0 * t * d * v
        for _, va in self._folds():
            tva = len(va)
            f += 2.0 * tva * d * d + 2.0 * tva * d * v
            f += g * LANCZOS_STEPS * 2.0 * d * d
            f += g * a * (d ** 3 / 3.0 + 2.0 * d * d * tva
                          + 2.0 * tva * d * v + SCORE * tva * v)
        f += 2.0 * t * d * v + g * LANCZOS_STEPS * 2.0 * d * d
        f += g * a * (d ** 3 / 3.0 + 2.0 * d * d * t_te)
        return f + 2.0 * t_te * d * v + SCORE * t_te * v
