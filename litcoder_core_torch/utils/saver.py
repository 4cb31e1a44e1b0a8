"""Run-artifact persistence (twin of litcoder_core_tpu/utils/saver.py).

The run directory layout and file names are the JAX package's, so each
package loads the other's runs: run_<date>_<time>_<hash>/ holding
hyperparams.json, metrics.pkl, best_alphas.npy and, when asked for,
weights.npy. Tensors are copied to the host before they are written.
"""

import hashlib
import json
import logging
import pickle
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from litcoder_core_torch.utils.device import to_numpy

logger = logging.getLogger(__name__)


class ModelSaver:
    """Saves/loads encoding-model weights, alphas, hyperparams, metrics."""

    def __init__(self, base_dir: str = "results"):
        self.base_dir = Path(base_dir)
        self.base_dir.mkdir(parents=True, exist_ok=True)

    def _create_run_dir(self, hyperparams: Dict[str, Any]) -> Path:
        run_hash = hashlib.md5(
            json.dumps(hyperparams, sort_keys=True, default=str).encode()
        ).hexdigest()[:8]
        timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        # Two same-hyperparam runs in one second get a counter suffix
        # instead of overwriting each other.
        base = f"run_{timestamp}_{run_hash}"
        run_dir = self.base_dir / base
        n = 1
        while run_dir.exists():
            run_dir = self.base_dir / f"{base}-{n}"
            n += 1
        run_dir.mkdir(parents=True)
        with open(run_dir / "hyperparams.json", "w") as f:
            json.dump(hyperparams, f, indent=2, default=str)
        return run_dir

    def save_encoding_model(self, weights, best_alphas,
                            hyperparams: Dict[str, Any],
                            metrics: Dict[str, Any],
                            save_weights: bool = False) -> Path:
        """Save one run; weights optional (they can be GBs), alphas always."""
        run_dir = self._create_run_dir(hyperparams)
        if save_weights:
            np.save(run_dir / "weights.npy", to_numpy(weights))
        if best_alphas is not None:
            np.save(run_dir / "best_alphas.npy", to_numpy(best_alphas))
        with open(run_dir / "metrics.pkl", "wb") as f:
            pickle.dump(metrics, f)
        logger.info("Saved encoding model artifacts to %s", run_dir)
        return run_dir

    def load_encoding_model(
        self, run_dir: Union[str, Path]
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray],
               Dict[str, Any], Dict[str, Any]]:
        """(weights or None, best_alphas or None, hyperparams, metrics).
        metrics.pkl is unpickled: load only runs this project wrote."""
        run_dir = Path(run_dir)
        weights = (np.load(run_dir / "weights.npy")
                   if (run_dir / "weights.npy").exists() else None)
        best_alphas = (np.load(run_dir / "best_alphas.npy")
                       if (run_dir / "best_alphas.npy").exists() else None)
        with open(run_dir / "hyperparams.json") as f:
            hyperparams = json.load(f)
        with open(run_dir / "metrics.pkl", "rb") as f:
            metrics = pickle.load(f)
        return weights, best_alphas, hyperparams, metrics

    def list_runs(self) -> List[Dict[str, Any]]:
        """Every run under base_dir, newest first: run_dir, timestamp
        (date_time of the directory name), hyperparams and metrics. A run
        that fails to load is logged and skipped."""
        runs = []
        for run_dir in self.base_dir.glob("run_*"):
            if not run_dir.is_dir():
                continue
            try:
                with open(run_dir / "hyperparams.json") as f:
                    hyperparams = json.load(f)
                with open(run_dir / "metrics.pkl", "rb") as f:
                    metrics = pickle.load(f)
                runs.append({
                    "run_dir": str(run_dir),
                    # run_{%Y%m%d}_{%H%M%S}_{hash}: keep date AND time so
                    # same-day runs sort chronologically.
                    "timestamp": "_".join(run_dir.name.split("_")[1:3]),
                    "hyperparams": hyperparams,
                    "metrics": metrics,
                })
            except Exception as e:
                logger.warning("Error loading run %s: %s", run_dir, e)
        runs.sort(key=lambda x: x["timestamp"], reverse=True)
        return runs
