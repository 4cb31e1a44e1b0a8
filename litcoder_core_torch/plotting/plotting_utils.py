"""Experiment loggers and brain plots (twin of
litcoder_core_tpu/plotting/plotting_utils.py).

The same Logger ABC (log_scalar / log_image / log_histogram), NullLogger,
W&B and TensorBoard backends, and BrainPlotter.log_plots contract, with the
JAX package's logger names. Plotting runs on the host, after the fit, on
numpy copies of the metrics. matplotlib, seaborn, nilearn, wandb and
tensorboard are imported inside the functions that need them, so the
package imports without them; without nilearn the surface panels are
skipped with a warning while histograms and scalars still log.
"""

import io
import logging
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

# fsaverage5 vertices per hemisphere.
FSAVERAGE5_VERTS_PER_HEMI = 10242


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


class Logger(ABC):
    """Abstract logging backend."""

    @abstractmethod
    def log_scalar(self, name: str, value: float,
                   step: Optional[int] = None) -> None: ...

    @abstractmethod
    def log_image(self, name: str, figure: Any,
                  step: Optional[int] = None) -> None: ...

    @abstractmethod
    def log_histogram(self, name: str, values: np.ndarray,
                      step: Optional[int] = None) -> None: ...


class NullLogger(Logger):
    """Drops everything; records names for tests and headless runs."""

    def __init__(self):
        self.scalars: Dict[str, float] = {}
        self.images = []
        self.histograms = []

    def log_scalar(self, name, value, step=None):
        self.scalars[name] = value

    def log_image(self, name, figure, step=None):
        self.images.append(name)

    def log_histogram(self, name, values, step=None):
        self.histograms.append(name)


class WandBLogger(Logger):
    """Weights & Biases backend; `wandb` is imported here, not with the
    module."""

    def __init__(self):
        try:
            import wandb
        except ImportError as e:
            raise ImportError(
                "wandb not installed. Install with: pip install wandb"
            ) from e
        self.wandb = wandb

    def log_scalar(self, name, value, step=None):
        log_dict = {name: value}
        if step is not None:
            log_dict["step"] = step
        self.wandb.log(log_dict)

    def log_image(self, name, figure, step=None):
        log_dict = {name: self.wandb.Image(figure)}
        if step is not None:
            log_dict["step"] = step
        self.wandb.log(log_dict)

    def log_histogram(self, name, values, step=None):
        log_dict = {name: self.wandb.Histogram(values)}
        if step is not None:
            log_dict["step"] = step
        self.wandb.log(log_dict)


class TensorBoardLogger(Logger):
    """TensorBoard backend through torch.utils.tensorboard (which needs the
    `tensorboard` package), imported here, not with the module."""

    def __init__(self, log_dir: str = "runs"):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "tensorboard not installed. Install with: "
                "pip install tensorboard torch"
            ) from e
        self.writer = SummaryWriter(log_dir)

    def log_scalar(self, name, value, step=None):
        self.writer.add_scalar(name, value, step)

    def log_image(self, name, figure, step=None):
        buf = io.BytesIO()
        figure.savefig(buf, format="png", bbox_inches="tight", dpi=150)
        buf.seek(0)
        try:
            from PIL import Image

            img_array = np.array(Image.open(buf))
        except ImportError:
            import matplotlib.image as mpimg

            buf.seek(0)
            img_array = (mpimg.imread(buf, format="png") * 255).astype(np.uint8)
        if img_array.ndim == 3:
            img_array = img_array.transpose(2, 0, 1)
        self.writer.add_image(name, img_array, step, dataformats="CHW")
        buf.close()

    def log_histogram(self, name, values, step=None):
        self.writer.add_histogram(name, values, step)

    def close(self):
        self.writer.close()


class BrainPlotter:
    """Brain surface and correlation-distribution plots."""

    def __init__(self, logger: Logger):
        self.logger = logger

    @staticmethod
    def plot_surface_correlations(correlations, significant_mask,
                                  title: str = "Significant Prediction Correlations",
                                  only_significant: bool = True,
                                  is_volume: bool = False):
        """4-view fsaverage5 stat maps with one shared symmetric colorbar.
        Returns None (with a log line) for volume data or when nilearn is
        unavailable."""
        if is_volume:
            logger.info("Skipping surface plotting for volume data")
            return None
        try:
            from nilearn import datasets, plotting
            from nilearn.plotting.cm import cold_hot
        except ImportError:
            logger.warning(
                "nilearn not installed — skipping surface plots "
                "(histograms and scalars still logged)"
            )
            return None
        plt = _plt()
        from matplotlib.colors import Normalize

        fsaverage = datasets.fetch_surf_fsaverage(mesh="fsaverage5")
        N = FSAVERAGE5_VERTS_PER_HEMI

        masked = np.asarray(correlations, float).copy()
        if only_significant:
            masked[~np.asarray(significant_mask, bool)] = np.nan
        left, right = masked[:N], masked[N:2 * N]

        vmax = np.nanmax(np.abs(masked))
        if not np.isfinite(vmax) or vmax == 0:
            vmax = 1.0
        norm = Normalize(vmin=-vmax, vmax=vmax)

        fig = plt.figure(figsize=(15, 10))
        panels = [
            (231, "infl_left", left, "left", "lateral", "Left Lateral"),
            (232, "infl_left", left, "left", "medial", "Left Medial"),
            (234, "infl_right", right, "right", "lateral", "Right Lateral"),
            (235, "infl_right", right, "right", "medial", "Right Medial"),
        ]
        for pos, mesh, data, hemi, view, panel_title in panels:
            ax = fig.add_subplot(pos, projection="3d")
            plotting.plot_surf_stat_map(
                fsaverage[mesh], data, hemi=hemi, view=view, colorbar=False,
                axes=ax, cmap=cold_hot, vmin=-vmax, vmax=vmax,
                title=panel_title,
            )
        sm = plt.cm.ScalarMappable(norm=norm, cmap=cold_hot)
        sm.set_array([])
        cax = fig.add_axes([0.92, 0.15, 0.02, 0.7])
        fig.colorbar(sm, cax=cax)
        plt.suptitle(title, fontsize=16)
        plt.tight_layout(rect=[0.03, 0.03, 0.9, 0.97])
        return fig

    @staticmethod
    def plot_all_correlations_histogram(
        correlations, title: str = "All Correlations Distribution"
    ):
        plt = _plt()
        import seaborn as sns

        fig = plt.figure(figsize=(10, 6))
        sns.set_theme(style="whitegrid")
        valid = correlations[~np.isnan(correlations)]
        sns.histplot(valid, bins=100, color="blue", label="All", kde=True,
                     stat="density")
        plt.legend()
        plt.xlabel("Correlation")
        plt.ylabel("Density")
        plt.title(title)
        return fig

    @staticmethod
    def plot_significant_correlations_histogram(
        correlations, significant_mask,
        title: str = "Significant Correlations Distribution",
    ):
        plt = _plt()
        import seaborn as sns

        fig = plt.figure(figsize=(10, 6))
        sns.set_theme(style="whitegrid")
        sig = correlations[np.asarray(significant_mask, bool)]
        valid = sig[~np.isnan(sig)]
        sns.histplot(valid, bins=100, color="green", label="Significant",
                     kde=True, stat="density")
        plt.legend()
        plt.xlabel("Correlation")
        plt.ylabel("Density")
        plt.title(title)
        return fig

    def log_plots(self, correlations, significant_mask, prefix: str = "",
                  step: Optional[int] = None, is_volume: bool = False,
                  language_mask=None,
                  roi_masks: Optional[Dict[str, Any]] = None):
        """Log surface maps, histograms, and per-mask summaries."""
        plt = _plt()

        def _sanitize(name: str) -> str:
            return "".join(
                ch if ch.isalnum() or ch in ("_", "-") else "_"
                for ch in name.strip()
            ).lower()

        full_len = 2 * FSAVERAGE5_VERTS_PER_HEMI
        correlations = np.asarray(correlations)
        significant_mask = np.asarray(significant_mask, dtype=bool)
        if not is_volume and correlations.shape[0] != full_len:
            raise ValueError(
                f"`correlations` must be length {full_len}, "
                f"got {correlations.shape}"
            )
        if significant_mask.shape[0] != correlations.shape[0]:
            raise ValueError(
                "`significant_mask` must match correlations length, got "
                f"{significant_mask.shape} vs {correlations.shape}"
            )

        fig_all = self.plot_all_correlations_histogram(correlations)
        self.logger.log_image(f"{prefix}correlation_histogram_all", fig_all, step)
        plt.close(fig_all)
        valid = correlations[~np.isnan(correlations)]
        self.logger.log_histogram(
            f"{prefix}correlation_histogram_data_all", valid, step
        )

        if not is_volume:
            for key, only_sig, title in [
                ("brain_surface_significant", True,
                 "Significant Prediction Correlations"),
                ("brain_surface_all", False, "All Prediction Correlations"),
            ]:
                fig = self.plot_surface_correlations(
                    correlations, significant_mask, title=title,
                    only_significant=only_sig, is_volume=is_volume,
                )
                if fig is not None:
                    self.logger.log_image(f"{prefix}{key}", fig, step)
                    plt.close(fig)

        fig_sig = self.plot_significant_correlations_histogram(
            correlations, significant_mask
        )
        self.logger.log_image(
            f"{prefix}correlation_histogram_significant", fig_sig, step
        )
        plt.close(fig_sig)
        sig = correlations[significant_mask]
        self.logger.log_histogram(
            f"{prefix}correlation_histogram_data_significant",
            sig[~np.isnan(sig)], step,
        )

        def _mask_summary(mask, key_base: str, surface_title: str):
            mask = np.asarray(mask, dtype=bool)
            if mask.shape[0] != correlations.shape[0]:
                raise ValueError(
                    f"mask for '{key_base}' must match correlations length, "
                    f"got {mask.shape} vs {correlations.shape}"
                )
            vals = correlations[mask]
            mean_v = float(np.nanmean(vals)) if vals.size else np.nan
            median_v = float(np.nanmedian(vals)) if vals.size else np.nan
            self.logger.log_scalar(f"{prefix}{key_base}_mean", mean_v, step)
            self.logger.log_scalar(f"{prefix}{key_base}_median", median_v, step)
            clean = vals[~np.isnan(vals)]
            if clean.size:
                self.logger.log_histogram(f"{prefix}{key_base}_hist", clean, step)
            if not is_volume:
                fig = self.plot_surface_correlations(
                    correlations, mask, title=surface_title,
                    only_significant=True, is_volume=is_volume,
                )
                if fig is not None:
                    self.logger.log_image(
                        f"{prefix}{key_base}_surface", fig, step
                    )
                    plt.close(fig)

        if language_mask is not None:
            _mask_summary(language_mask, "lanA", "Language Network — Masked")
        if roi_masks:
            if not isinstance(roi_masks, dict):
                raise TypeError(
                    "`roi_masks` must be a dict like {'V1': mask, ...}"
                )
            for name, mask in roi_masks.items():
                _mask_summary(mask, _sanitize(name), f"{name} — Masked")
