"""Pipeline orchestrator (twin of litcoder_core_tpu/trainer.py).

Same flow and constructor contract as the JAX AbstractTrainer: extract ->
downsample -> FIR -> structure -> fit_predict -> log/save. Structuring is
the LeBel train/test split (use_train_test_split=True, the fit's train/test
mode) or the LPP/Narratives concatenation (False: the fit's full nested-CV
mode, whose metrics add the majority-mask keys and whose weights and alphas
are the means over the outer folds). Tensors live on `device` from the
fused Lanczos+FIR kernel through structuring and into the fit; the only
host copies are the explicit ones for metrics and saving.

Features come from any registered extractor: the language-model one's
numpy (n_words, d_model) layer goes into the fused kernel or the
Downsampler like static embeddings, on the story's word times; the speech
extractor's (features, times) tuple goes in on its window end times
instead. Logging follows the JAX trainer: TensorBoard by default, W&B or a
NullLogger on request, and after the fit the correlation histograms (and,
at fsaverage5 resolution, surface maps) through BrainPlotter on the host.

concat_features=False keeps each extractor's delayed block as its own
feature space (the two-stage path cuts them to the common story length;
the fused path launches the kernel once per downsampled space and does not
interleave them), structures each space on its own, and hands the list of
spaces to a multi-space model (BandedRidgeModel, StackedRidgeModel) in
train/test mode. Before extraction, the stories' responses are copied to
the card on a side stream from pinned memory when they total at most
4 GiB (the JAX trainer's budget), so the copy overlaps extraction.

Voxel sharding and tensor-parallel extraction come in through the model's
`mesh`/`n_devices` and the extractors' `mesh` (parallel/mesh.py,
parallel/tp.py); the trainer itself is the same either way.

Each stage of train() is the span `litcoder.train.<stage>`
(utils.profiling.StageTimer); inside log_and_save, `litcoder.log.metrics`
(the logged scalars and the plots) and `litcoder.log.save` (the saver).
"""

import logging
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from litcoder_core_torch.features.factory import FeatureExtractorFactory
from litcoder_core_torch.features.fir_expander import FIR
from litcoder_core_torch.ops.lanczos_fir import lanczos_fir
from litcoder_core_torch.ops.stats import trainer_zscore
from litcoder_core_torch.plotting.plotting_utils import (
    BrainPlotter,
    NullLogger,
    TensorBoardLogger,
    WandBLogger,
)
from litcoder_core_torch.utils.device import (
    as_f32,
    resolve_device,
    synchronizer,
)
from litcoder_core_torch.utils.profiling import StageTimer, annotate
from litcoder_core_torch.utils.saver import ModelSaver

logger = logging.getLogger(__name__)


class AbstractTrainer:
    """Orchestrates the encoding pipeline with injected components."""

    def __init__(
        self,
        assembly: Any,
        feature_extractors: List[Any],
        downsampler: Any,
        model: Any,
        fir_delays: List[int],
        trimming_config: Dict,
        use_train_test_split: bool = False,
        layer_idx: int = 9,
        lookback: int = 256,
        dataset_type: str = "unknown",
        logger_backend: str = "tensorboard",
        wandb_project_name: str = "abstract-trainer",
        results_dir: str = "results",
        run_name: Optional[str] = None,
        downsample_config: Optional[Dict] = None,
        story_selection: Optional[List[str]] = None,
        concat_features: bool = True,
        fused_downsample_fir: Any = "auto",
        device_resident: Any = "auto",
        device="cuda",
    ):
        """concat_features=True hstacks the extractors' features (one
        feature space); False keeps one space per extractor for the
        multi-space models (BandedRidgeModel, StackedRidgeModel), train/test
        mode only.

        fused_downsample_fir: 'auto' runs Lanczos downsampling and FIR
        delays as one fused kernel (ops.lanczos_fir) whenever that equals
        the two-stage path (method 'lanczos' without rectify, all delays
        positive); False keeps the two-stage path; True requires the fused
        one. `device` is where every stage runs ('cuda' by default; with no
        card it raises). `device_resident` is accepted for the JAX
        signature and dropped: the port's stages always keep their tensors
        on `device`, and the response prefetch follows the JAX trainer's
        budget rule (_prefetch_brain_data), not this flag."""
        del device_resident
        self.device = resolve_device(device)
        self.assembly = assembly
        self.concat_features = concat_features
        self.fused_downsample_fir = fused_downsample_fir
        self.feature_extractors = feature_extractors
        self.downsampler = downsampler
        self.model = model
        self.fir_delays = fir_delays
        self.trimming_config = trimming_config
        self.use_train_test_split = use_train_test_split
        self.downsample_config = downsample_config or {}
        self.layer_idx = layer_idx
        self.lookback = lookback
        self.dataset_type = dataset_type

        if story_selection is None:
            self.stories_to_process = self.assembly.stories
        elif isinstance(story_selection, int):
            # 1-based single story index.
            self.stories_to_process = [
                self.assembly.stories[story_selection - 1]]
        else:
            self.stories_to_process = story_selection

        self.setup_logger(logger_backend, wandb_project_name, results_dir,
                          run_name)
        self.model_saver = ModelSaver(base_dir=results_dir)
        self.brain_plotter = BrainPlotter(self.experiment_logger)
        self._brain_prefetch = None

    def setup_logger(self, backend: str, project_name: str, results_dir: str,
                     run_name: Optional[str]):
        if run_name is None:
            run_name = (
                f"abstract-trainer-{datetime.now().strftime('%Y%m%d-%H%M%S')}"
            )
        if backend == "wandb":
            import wandb

            wandb.init(project=project_name, name=run_name)
            self.experiment_logger = WandBLogger()
        elif backend == "tensorboard":
            self.experiment_logger = TensorBoardLogger(
                log_dir=f"{results_dir}/runs/{run_name}"
            )
        elif backend == "none":
            self.experiment_logger = NullLogger()
        else:
            raise ValueError(f"Unsupported logger_backend '{backend}'")

    # ------------------------------------------------------------ stage 1

    def _extract_single_features(self, extractor, story: str, idx: int):
        return FeatureExtractorFactory.extract_features_with_caching(
            extractor, self.assembly, story, idx, self.layer_idx,
            self.lookback, self.dataset_type,
        )

    def _with_times(self, features, idx: int):
        """(features, the times they are sampled at): a speech extractor's
        (features, times) tuple, else the story's word times."""
        if isinstance(features, tuple):
            return features
        return features, self.assembly.get_data_times()[idx]

    def _should_downsample(self, extractor) -> bool:
        """Wordrate features are already TR-binned; every other extractor
        gives one row per word (embeddings, language model) or per speech
        window."""
        return "wordrate" not in extractor.__class__.__name__.lower()

    def extract_and_downsample_features(self) -> Dict:
        """Per-story extraction + downsampling (two-stage path), with any
        Downsampler method: downsample_config names it ('rect' when it does
        not) and its parameters; the story's word times (a speech tuple's
        own times), TR times and split indices always go along, as in the
        JAX trainer."""
        all_features = {}
        for story in self.stories_to_process:
            idx = self.assembly.stories.index(story)
            story_features = []
            for extractor in self.feature_extractors:
                features = self._extract_single_features(extractor, story, idx)
                if self._should_downsample(extractor):
                    features, data_times = self._with_times(features, idx)
                    features = self.downsampler.downsample(
                        data=features,
                        data_times=data_times,
                        tr_times=self.assembly.get_tr_times()[idx],
                        split_indices=self.assembly.get_split_indices()[idx],
                        device=self.device,
                        **self.downsample_config,
                    )
                story_features.append(as_f32(features, self.device))
            min_len = min(f.shape[0] for f in story_features)
            story_features = [f[:min_len] for f in story_features]
            if self.concat_features:
                all_features[story] = torch.cat(story_features, dim=1)
                logger.info("Story %s: feature shape %s", story,
                            tuple(all_features[story].shape))
            else:
                all_features[story] = story_features  # list of spaces
                logger.info("Story %s: %d feature spaces %s", story,
                            len(story_features),
                            [tuple(f.shape) for f in story_features])
        return all_features

    # ------------------------------------------------- fused stages 1+2

    def _fused_eligible(self) -> bool:
        """True when the fused kernel equals Downsampler('lanczos') followed
        by FIR.make_delayed: lanczos without rectify, window and cutoff_mult
        given, all FIR delays positive (so per-story truncation commutes
        with the delay stacking)."""
        if not self.fused_downsample_fir:
            return False
        eligible = (
            self.downsample_config.get("method") == "lanczos"
            and "window" in self.downsample_config
            and "cutoff_mult" in self.downsample_config
            and not self.downsample_config.get("rectify", False)
            and bool(self.fir_delays)
            and all(int(d) > 0 for d in self.fir_delays)
        )
        if self.fused_downsample_fir is True and not eligible:
            raise ValueError(
                "fused_downsample_fir=True requires downsample method "
                "'lanczos' (rectify=False) with explicit window/"
                "cutoff_mult and strictly positive fir_delays; got "
                f"config={self.downsample_config!r}, "
                f"delays={self.fir_delays}"
            )
        return eligible

    def extract_and_delay_features_fused(self) -> Dict:
        """Stages 1+2 with one kernel launch per story and downsampled
        extractor. Equal to extract_and_downsample_features() followed by
        apply_fir_delays(): blocks are cut to the common story length and,
        with concat_features, re-interleaved by delay, so the column order
        is that of FIR.make_delayed(hstack(spaces)); without it each block
        stays its own space."""
        delays = [int(d) for d in self.fir_delays]
        n_delays = len(delays)
        window = self.downsample_config["window"]
        cutoff_mult = self.downsample_config["cutoff_mult"]

        all_delayed = {}
        for story in self.stories_to_process:
            idx = self.assembly.stories.index(story)
            tr_times = self.assembly.get_tr_times()[idx]
            spaces = []
            for extractor in self.feature_extractors:
                features = self._extract_single_features(extractor, story, idx)
                if self._should_downsample(extractor):
                    data, data_times = self._with_times(features, idx)
                    block = lanczos_fir(
                        data, data_times, tr_times, delays=delays,
                        window=window, cutoff_mult=cutoff_mult,
                        device=self.device,
                    )
                else:
                    block = FIR.make_delayed(as_f32(features, self.device),
                                             delays)
                spaces.append(block)
            # With strictly positive delays make_delayed(f[:m]) equals
            # make_delayed(f)[:m], so aligning after the FIR is exact.
            min_len = min(b.shape[0] for b in spaces)
            spaces = [b[:min_len] for b in spaces]
            if not self.concat_features:
                all_delayed[story] = spaces
                logger.info("Story %s (fused): %d feature spaces %s", story,
                            len(spaces), [tuple(b.shape) for b in spaces])
                continue
            if len(spaces) == 1:
                combined = spaces[0]
            else:
                combined = torch.cat(
                    [b.reshape(min_len, n_delays, -1) for b in spaces],
                    dim=2,
                ).reshape(min_len, -1)
            all_delayed[story] = combined
            logger.info("Story %s (fused): delayed shape %s", story,
                        tuple(combined.shape))
        return all_delayed

    # ------------------------------------------------------------ stage 2

    def apply_fir_delays(self, features: Dict) -> Dict:
        """FIR delays per story; a list of spaces (per-space mode) is
        delayed space by space."""
        return {story: ([FIR.make_delayed(f, self.fir_delays) for f in feat]
                        if isinstance(feat, list)
                        else FIR.make_delayed(feat, self.fir_delays))
                for story, feat in features.items()}

    # ------------------------------------------------------------ stage 3

    def _prefetch_brain_data(self, budget_bytes: int = 4 << 30):
        """Start the stories' response copies to `device` before
        extraction, so they ride the link while the extraction stage runs.
        On a card: pinned host copies, non-blocking, on a side stream whose
        completion event structure_data waits on. Budget-gated as in the
        JAX trainer: above `budget_bytes` of responses the copies stay in
        structure_data. Returns (tensors by story, event or None) or
        None."""
        arrs = {
            story: self.assembly.get_brain_data()[
                self.assembly.stories.index(story)]
            for story in self.stories_to_process
        }
        total = sum(int(np.asarray(a).nbytes) for a in arrs.values())
        if total > budget_bytes:
            logger.info(
                "brain-data prefetch skipped: %.1f GB exceeds the %.1f GB "
                "device budget (transfers stay in structure_data)",
                total / 2**30, budget_bytes / 2**30)
            return None
        if self.device.type != "cuda":
            return {s: as_f32(a, self.device) for s, a in arrs.items()}, None
        stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(stream):
            copies = {
                s: torch.from_numpy(np.ascontiguousarray(a, np.float32))
                .pin_memory().to(self.device, non_blocking=True)
                for s, a in arrs.items()
            }
        event = torch.cuda.Event()
        event.record(stream)
        return copies, event

    def structure_data(self, features: Dict) -> Dict:
        if self._brain_prefetch is not None:
            brain_data, event = self._brain_prefetch
            if event is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(event)
                for t in brain_data.values():
                    # Allocated on the side stream, used on this one.
                    t.record_stream(consumer)
        else:
            brain_data = {
                story: as_f32(self.assembly.get_brain_data()[
                    self.assembly.stories.index(story)], self.device)
                for story in self.stories_to_process
            }
        self._brain_prefetch = None
        if self.use_train_test_split:
            return self._create_train_test_split(features, brain_data)
        return self._create_concatenated_data(features, brain_data)

    def _create_train_test_split(self, features: Dict, brain_data: Dict
                                 ) -> Dict:
        """LeBel style: the last story is held out; per-story z-score, trim,
        then vstack. In per-space mode each feature space is structured on
        its own and Rstim/Pstim are lists of spaces."""
        stories = list(features.keys())
        train_stories, test_stories = stories[:-1], stories[-1:]
        cfg = self.trimming_config

        def stack(source, story_list, lo_key, hi_key):
            return torch.vstack([
                trainer_zscore(source[s][cfg.get(lo_key, 0):
                                         cfg.get(hi_key, None)])
                for s in story_list
            ])

        def stack_features(source, story_list, lo_key, hi_key):
            return torch.nan_to_num(stack(source, story_list, lo_key,
                                          hi_key))

        if isinstance(features[stories[0]], list):
            spaces = [{s: f[b] for s, f in features.items()}
                      for b in range(len(features[stories[0]]))]
            X_train = [stack_features(sp, train_stories,
                                      "train_features_start",
                                      "train_features_end") for sp in spaces]
            X_test = [stack_features(sp, test_stories,
                                     "test_features_start",
                                     "test_features_end") for sp in spaces]
        else:
            X_train = stack_features(features, train_stories,
                                     "train_features_start",
                                     "train_features_end")
            X_test = stack_features(features, test_stories,
                                    "test_features_start",
                                    "test_features_end")
        Y_train = stack(brain_data, train_stories, "train_targets_start",
                        "train_targets_end")
        Y_test = stack(brain_data, test_stories, "test_targets_start",
                       "test_targets_end")

        def shape(x):
            return ([tuple(t.shape) for t in x] if isinstance(x, list)
                    else tuple(x.shape))

        logger.info("Train: X%s Y%s | Test: X%s Y%s", shape(X_train),
                    shape(Y_train), shape(X_test), shape(Y_test))
        return {"Rstim": X_train, "Rresp": Y_train,
                "Pstim": X_test, "Presp": Y_test}

    def _create_concatenated_data(self, features: Dict, brain_data: Dict
                                  ) -> Dict:
        """LPP/Narratives style: concatenate in story order, trim globally;
        train() then fits in full nested-CV mode (no test set)."""
        cfg = self.trimming_config
        if not self.concat_features:
            raise ValueError(
                "Banded (concat_features=False) training requires "
                "use_train_test_split=True"
            )
        X = torch.vstack([features[s] for s in self.stories_to_process])
        Y = torch.vstack([brain_data[s] for s in self.stories_to_process])
        X = X[cfg.get("features_start", 0):cfg.get("features_end", None)]
        Y = Y[cfg.get("targets_start", 0):cfg.get("targets_end", None)]
        logger.info("Final: X%s Y%s", tuple(X.shape), tuple(Y.shape))
        return {"X": X, "Y": Y}

    # ------------------------------------------------------------ stages 4-5

    def train(self, **model_kwargs) -> Dict[str, Any]:
        """Run the complete pipeline with per-stage wall-clock accounting;
        on a card each stage ends in a synchronize, so the split is real."""
        timer = StageTimer(sync_fn=synchronizer(self.device))
        self._brain_prefetch = self._prefetch_brain_data()
        if self._fused_eligible():
            with timer.stage("extract_downsample_fir_fused"):
                delayed = self.extract_and_delay_features_fused()
        else:
            with timer.stage("extract_and_downsample"):
                features = self.extract_and_downsample_features()
            with timer.stage("fir_delays"):
                delayed = self.apply_fir_delays(features)
        with timer.stage("structure_data"):
            data = self.structure_data(delayed)

        logger.info("Starting model training...")
        banded = "Rstim" in data and isinstance(data["Rstim"], list)
        with timer.stage("fit_predict"):
            if banded:
                # Multi-space model API (banded or stacked), train/test
                # mode: banded returns (..., best_gammas), stacked 3.
                out = self.model.fit_predict(
                    data["Rstim"], data["Rresp"], X_tests=data["Pstim"],
                    y_test=data["Presp"], **model_kwargs,
                )
                metrics, weights, best_alphas = out[:3]
            elif "Rstim" in data:
                metrics, weights, best_alphas = self.model.fit_predict(
                    features=data["Rstim"], targets=data["Rresp"],
                    X_test=data["Pstim"], y_test=data["Presp"],
                    **model_kwargs,
                )
            else:
                metrics, weights, best_alphas = self.model.fit_predict(
                    features=data["X"], targets=data["Y"], **model_kwargs,
                )

        with timer.stage("log_and_save"):
            with annotate("litcoder.log.metrics"):
                self.log_metrics(metrics)
            with annotate("litcoder.log.save"):
                self.save_model(weights, best_alphas, metrics, model_kwargs)
        stage_seconds = timer.report()
        for name, dt in stage_seconds.items():
            self.experiment_logger.log_scalar(f"stage_seconds/{name}", dt)
        metrics["trainer_stage_seconds"] = dict(stage_seconds)
        logger.info("Training complete. Median correlation: %.4f",
                    metrics["median_score"])
        return metrics

    def log_metrics(self, metrics: Dict):
        log = self.experiment_logger
        log.log_scalar("median_correlation", float(metrics["median_score"]))
        log.log_scalar("mean_correlation", float(metrics["mean_score"]))
        log.log_scalar("std_correlation", float(metrics["std_score"]))
        if "correlations" in metrics and "significant_mask" in metrics:
            correlations = np.array(metrics["correlations"])
            mask = np.array(metrics["significant_mask"], dtype=bool)
            # Surface plots only apply at fsaverage5 resolution; other voxel
            # counts are treated as volume-style (histograms only).
            is_volume = correlations.shape[0] != 20484
            try:
                self.brain_plotter.log_plots(correlations, mask, "", None,
                                             is_volume)
            except Exception as e:
                logger.warning("Brain plotting failed: %s", e)
        if "best_alpha" in metrics:
            log.log_scalar("best_alpha", float(metrics["best_alpha"]))
        if "n_significant" in metrics:
            log.log_scalar("n_significant_voxels",
                           float(metrics["n_significant"]))

    def save_model(self, weights, best_alphas, metrics, model_kwargs):
        hyperparams = {
            "fir_delays": self.fir_delays,
            "trimming_config": self.trimming_config,
            "use_train_test_split": self.use_train_test_split,
            "downsample_config": self.downsample_config,
            "layer_idx": self.layer_idx,
            "lookback": self.lookback,
            "dataset_type": self.dataset_type,
            "stories_processed": len(self.stories_to_process),
            **model_kwargs,
        }
        self.model_saver.save_encoding_model(
            weights=weights, best_alphas=best_alphas,
            hyperparams=hyperparams, metrics=metrics,
        )
