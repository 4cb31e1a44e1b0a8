"""Sweep utilities of the port (twin of litcoder_core_tpu/sweeps.py):
all-layer comparisons over cached activations and resumable grids of CLI
runs.

Once one run has populated the all-layer activation cache, every further
layer costs only the ridge fit on the card. run_subject_sweep and
run_grid_sweep drive the port's cli.run once per config, on
config['device'] ('cuda' when absent).
"""

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)


def run_layer_sweep(
    make_trainer: Callable[[int], Any],
    layers: Sequence[int],
    train_kwargs: Optional[Dict[str, Any]] = None,
) -> List[Dict[str, Any]]:
    """Train one model per layer and collect summary metrics.

    Args:
        make_trainer: layer_idx -> configured AbstractTrainer. The FIRST call
            populates the all-layer activation cache; later layers hit it.
        layers: layer indices to sweep.
        train_kwargs: forwarded to trainer.train().

    Returns:
        List of {"layer", "median_score", "mean_score", "n_significant"}
        sorted by layer order given.
    """
    layers = list(layers)
    if not layers:
        raise ValueError("run_layer_sweep: `layers` is empty")
    train_kwargs = train_kwargs or {}
    results = []
    for layer in layers:
        trainer = make_trainer(layer)
        try:
            metrics = trainer.train(**train_kwargs)
        finally:
            closer = getattr(trainer.experiment_logger, "close", None)
            if closer:  # one SummaryWriter per layer would otherwise leak
                closer()
        row = {
            "layer": int(layer),
            "median_score": float(metrics["median_score"]),
            "mean_score": float(metrics["mean_score"]),
            "n_significant": int(metrics.get("n_significant", 0)),
        }
        logger.info("layer %d: median r = %.4f (%d significant)",
                    layer, row["median_score"], row["n_significant"])
        results.append(row)
    best = max(results, key=lambda r: r["median_score"])
    logger.info("best layer: %d (median r = %.4f)", best["layer"],
                best["median_score"])
    return results


def run_subject_sweep(configs: Sequence[Dict[str, Any]],
                      checkpoint_dir: Optional[str] = None,
                      ) -> List[Dict[str, Any]]:
    """Run the unified pipeline for a list of CLI-style config dicts.

    Subjects x models sweeps are embarrassingly parallel: across hosts,
    launch one process per config (no collectives needed). Within one
    process this runs them one after another on config['device'].

    Each config is what `litcoder_core_torch.cli.run` accepts (the
    parsed-args dict). Returns one summary row per config; failures are
    recorded, not raised, so a sweep survives individual bad subjects.

    checkpoint_dir enables RESUME: each completed config's summary is
    written to `<checkpoint_dir>/<hash>.json` and skipped on re-runs — an
    interrupted sweep continues where it stopped. The file name is the md5
    of the config as JSON (sorted keys, str() for anything else), the
    JAX package's key.
    """
    import hashlib
    import json
    from pathlib import Path

    from litcoder_core_torch.cli import run

    ckpt = Path(checkpoint_dir) if checkpoint_dir else None
    if ckpt:
        ckpt.mkdir(parents=True, exist_ok=True)

    def _ckpt_path(config):
        key = hashlib.md5(
            json.dumps(config, sort_keys=True, default=str).encode()
        ).hexdigest()
        return ckpt / f"{key}.json"

    results = []
    for config in configs:
        label = config.get("sweep_label") or (
            f"{config.get('dataset_type')}/{config.get('subject')}"
        )
        if ckpt:
            path = _ckpt_path(config)
            if path.exists():
                logger.info("sweep config %s: checkpoint hit, skipping",
                            label)
                results.append(json.loads(path.read_text()))
                continue
        run_config = {k: v for k, v in config.items() if k != "sweep_label"}
        try:
            metrics = run(run_config)
            row = {
                "config": label,
                "median_score": float(metrics["median_score"]),
                "n_significant": int(metrics.get("n_significant", 0)),
                "error": None,
            }
            # Link the sweep row to its persisted ModelSaver run (the
            # saved hyperparams/metrics/weights live there) so the summary
            # table indexes the full artifacts, not just these scalars.
            for key in ("subject", "layer_idx", "modality", "model_name"):
                if key in config:
                    row[key] = config[key]
            row["run_name"] = run_config.get("run_name")
        except Exception as e:  # keep sweeping past bad subjects
            logger.warning("sweep config %s failed: %s", label, e)
            row = {"config": label, "median_score": float("nan"),
                   "n_significant": 0, "error": str(e)}
        results.append(row)
        if ckpt and row["error"] is None:
            _ckpt_path(config).write_text(json.dumps(row))
    return results


def expand_grid(base_config: Dict[str, Any],
                **axes: Sequence[Any]) -> List[Dict[str, Any]]:
    """Cartesian subject x layer x modality (x anything) grid of CLI
    configs — the outermost, embarrassingly parallel axis of the framework
    (job farming across hosts, not collectives).

    Each keyword is a CLI config key with a sequence of values, e.g.
    expand_grid(base, subject=["UTS01", "UTS03"], layer_idx=[4, 8]).
    Every produced config carries a human-readable 'sweep_label' and a
    deterministic 'run_name' so ModelSaver artifacts are addressable per
    grid point and re-runs overwrite nothing.
    """
    from itertools import product

    if not axes:
        raise ValueError("expand_grid: no axes given")
    keys = sorted(axes)
    configs = []
    for combo in product(*(axes[k] for k in keys)):
        cfg = dict(base_config)
        cfg.update(dict(zip(keys, combo)))
        label = "_".join(f"{k}-{v}" for k, v in zip(keys, combo))
        cfg["sweep_label"] = label
        cfg.setdefault("run_name", f"sweep_{label}")
        configs.append(cfg)
    return configs


def summarize_sweep(results: List[Dict[str, Any]],
                    path: Optional[str] = None) -> str:
    """Render sweep rows as an aligned text table (and optionally write a
    JSON artifact next to a .csv twin) — the sweep's summary-table
    artifact. Returns the table string."""
    import csv
    import json
    import math

    if not results:
        return "(empty sweep)"
    cols = ["config", "median_score", "n_significant", "error"]
    extra = [k for k in ("subject", "layer_idx", "modality", "run_name")
             if any(k in r for r in results)]
    cols = cols[:1] + extra + cols[1:]

    def fmt(v):
        if isinstance(v, float):
            return "nan" if math.isnan(v) else f"{v:.4f}"
        return "" if v is None else str(v)

    rows = [[fmt(r.get(c)) for c in cols] for r in results]
    widths = [max(len(c), *(len(row[i]) for row in rows))
              for i, c in enumerate(cols)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths)),
             "  ".join("-" * w for w in widths)]
    lines += ["  ".join(v.ljust(w) for v, w in zip(row, widths))
              for row in rows]
    table = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            json.dump(results, f, indent=1)
        csv_path = path.rsplit(".", 1)[0] + ".csv"
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=cols, extrasaction="ignore")
            writer.writeheader()
            writer.writerows(results)
        logger.info("sweep summary written to %s (+ %s)", path, csv_path)
    return table


def run_grid_sweep(base_config: Dict[str, Any],
                   checkpoint_dir: Optional[str] = None,
                   summary_path: Optional[str] = None,
                   **axes: Sequence[Any]) -> List[Dict[str, Any]]:
    """expand_grid + run_subject_sweep + summarize_sweep in one call: the
    resumable subject x layer x modality farming entry point. Interrupted
    sweeps resume from checkpoint_dir; the summary table (JSON + CSV)
    lands at summary_path."""
    configs = expand_grid(base_config, **axes)
    logger.info("grid sweep: %d configs over axes %s", len(configs),
                sorted(axes))
    results = run_subject_sweep(configs, checkpoint_dir=checkpoint_dir)
    table = summarize_sweep(results, path=summary_path)
    for line in table.splitlines():
        logger.info("%s", line)
    return results
