"""Port parity for the experiment loggers and brain plots: the cases of
tests/test_plotting_utils.py against litcoder_core_torch's classes, the
same logger names as the JAX BrainPlotter, and WandBLogger against a stub
`wandb` module."""

import sys
import types

import numpy as np
import pytest
import torch

from litcoder_core_torch.plotting.plotting_utils import (
    FSAVERAGE5_VERTS_PER_HEMI,
    BrainPlotter,
    NullLogger,
    TensorBoardLogger,
    WandBLogger,
)
from litcoder_core_tpu.plotting import plotting_utils as jax_plotting

torch.set_num_threads(2)

rng = np.random.default_rng(15)
FULL = 2 * FSAVERAGE5_VERTS_PER_HEMI


def test_null_logger_records():
    log = NullLogger()
    log.log_scalar("a", 1.0)
    log.log_histogram("h", np.arange(3))
    log.log_image("i", None)
    assert log.scalars == {"a": 1.0}
    assert log.histograms == ["h"] and log.images == ["i"]
    assert FSAVERAGE5_VERTS_PER_HEMI == jax_plotting.FSAVERAGE5_VERTS_PER_HEMI


def _both(corr, mask, **kw):
    """(port NullLogger, JAX NullLogger) after log_plots on each."""
    port, ref = NullLogger(), jax_plotting.NullLogger()
    BrainPlotter(port).log_plots(corr, mask, **kw)
    jax_plotting.BrainPlotter(ref).log_plots(corr, mask, **kw)
    return port, ref


def _same_names(port, ref):
    assert port.images == ref.images
    assert port.histograms == ref.histograms
    assert port.scalars.keys() == ref.scalars.keys()
    for name, value in ref.scalars.items():
        np.testing.assert_array_equal(port.scalars[name], value)


def test_brain_plotter_logs_histograms_without_nilearn():
    corr = rng.normal(scale=0.2, size=FULL)
    port, ref = _both(corr, corr > 0.2, prefix="p_")
    _same_names(port, ref)
    assert "p_correlation_histogram_all" in port.images
    assert "p_correlation_histogram_significant" in port.images
    assert "p_correlation_histogram_data_all" in port.histograms


def test_brain_plotter_volume_mode_any_length():
    port, ref = _both(rng.normal(size=500), rng.uniform(size=500) > 0.5,
                      is_volume=True)
    _same_names(port, ref)
    assert port.images == ["correlation_histogram_all",
                           "correlation_histogram_significant"]
    assert port.histograms == ["correlation_histogram_data_all",
                               "correlation_histogram_data_significant"]


def test_brain_plotter_surface_length_check():
    with pytest.raises(ValueError, match="must be length"):
        BrainPlotter(NullLogger()).log_plots(np.zeros(100), np.zeros(100, bool))
    with pytest.raises(ValueError, match="must match correlations length"):
        BrainPlotter(NullLogger()).log_plots(np.zeros(100), np.zeros(99, bool),
                                             is_volume=True)


def test_brain_plotter_mask_summaries():
    corr = rng.normal(size=FULL)
    lang = np.zeros(FULL, bool)
    lang[:50] = True
    roi = {"V1!": np.ones(FULL, bool)}
    port, ref = _both(corr, corr > 0, language_mask=lang, roi_masks=roi)
    _same_names(port, ref)
    assert "lanA_mean" in port.scalars
    assert "v1__median" in port.scalars  # sanitized key
    with pytest.raises(ValueError, match="must match correlations length"):
        BrainPlotter(NullLogger()).log_plots(corr, corr > 0,
                                             language_mask=np.zeros(3, bool))
    with pytest.raises(TypeError, match="roi_masks"):
        BrainPlotter(NullLogger()).log_plots(corr, corr > 0,
                                             roi_masks=[lang])


def test_tensorboard_logger(tmp_path):
    log = TensorBoardLogger(log_dir=str(tmp_path / "tb"))
    log.log_scalar("x", 0.5, step=1)
    log.log_histogram("h", rng.normal(size=100), step=1)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    plt.plot([1, 2, 3])
    log.log_image("fig", fig, step=1)
    plt.close(fig)
    log.close()
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    events = EventAccumulator(str(tmp_path / "tb")).Reload()
    tags = events.Tags()
    assert tags["scalars"] == ["x"] and tags["histograms"] == ["h"]
    assert tags["images"] == ["fig"]


@pytest.fixture
def stub_wandb(monkeypatch):
    """A `wandb` module that records what it is given."""
    mod = types.ModuleType("wandb")
    mod.logged, mod.inits = [], []
    mod.init = lambda **kw: mod.inits.append(kw)
    mod.log = mod.logged.append
    mod.Image = lambda fig: ("image", fig)
    mod.Histogram = lambda values: ("histogram", len(values))
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def test_wandb_logger_with_a_stub(stub_wandb):
    log = WandBLogger()
    log.log_scalar("s", 0.25)
    log.log_scalar("s", 0.5, step=3)
    log.log_image("fig", "figure", step=1)
    log.log_histogram("h", np.arange(4.0))
    assert stub_wandb.logged == [
        {"s": 0.25}, {"s": 0.5, "step": 3},
        {"fig": ("image", "figure"), "step": 1}, {"h": ("histogram", 4)}]
    corr = rng.normal(size=300)
    BrainPlotter(log).log_plots(corr, corr > 0, is_volume=True)
    names = [next(iter(d)) for d in stub_wandb.logged[4:]]
    assert names == ["correlation_histogram_all",
                     "correlation_histogram_data_all",
                     "correlation_histogram_significant",
                     "correlation_histogram_data_significant"]


def test_wandb_logger_without_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    for cls in (WandBLogger, jax_plotting.WandBLogger):
        with pytest.raises(ImportError,
                           match="wandb not installed. Install with: pip "
                                 "install wandb"):
            cls()
