"""Entry 'train_lm': AbstractTrainer.train() from an assembly of LeBel-
shaped stories to metrics, with the port's LanguageModelFeatureExtractor on
a GPT-2 whose weights are drawn on the device (one train() per job).

Each job extracts every window anew: the extractor gets an activation
cache that never hits and stores nothing. The trainer logs to no backend
and writes its run directory (hyperparameters, metrics, alphas; no
weights) under a temporary directory that the run removes.

params:
  words_per_story, vocab_size            the traffic (traffic/stories.py);
  batch_size                              the extractor's batch;
  signal_rank, noise_std                  the planted signal (below);
  train                                   keyword arguments of train();
  route                                   the fit's metrics['solver_paths'];
  block                                   voxels per block in the reference.

The responses carry a planted signal that the layer's residual stream
holds linearly: each word's own token embedding (a row of the drawn wte)
times a (d, rank) projection, Lanczos-downsampled and delayed as the
features are, z-scored, times a (rank, V) mix of unit variance, plus unit
noise. The reference's forward runs only in the check, after the window.
"""

import shutil
import tempfile
from typing import Dict, List

import numpy as np
import torch

from cardbench import compare
from cardbench.metrics import _counts
from cardbench.precision import tf32
from cardbench.reference import folds as ref_folds
from cardbench.reference import gpt2 as ref_gpt2
from cardbench.reference import lanczos_fir as ref_lanczos
from cardbench.reference import lebel as ref_lebel
from cardbench.reference import ridge as ref_ridge
from cardbench.reference import stats as ref_stats
from cardbench.traffic.gpt2_weights import gpt2_weights
from cardbench.traffic.stories import StubTokenizer, lebel_stories, token_ids
from cardbench.entries.fit import alpha_grid

LEBEL_TRIM = {
    "train_features_start": 10, "train_features_end": -5,
    "train_targets_start": 0, "train_targets_end": None,
    "test_features_start": 50, "test_features_end": -5,
    "test_targets_start": 40, "test_targets_end": None,
}


class NoActivationCache:
    """An activation cache that never hits and stores nothing."""

    def _get_cache_key(self, **params) -> str:
        return ""

    def load_multi_layer_activations(self, key):
        return None

    def save_multi_layer_activations(self, key, activations, metadata):
        return None


def _build_model(config: Dict, weights: Dict[str, torch.Tensor], device):
    """GPT2Model of the configuration's shape on `device`, holding
    `weights` (every parameter of the model is among them)."""
    from transformers import GPT2Config, GPT2Model

    cfg = GPT2Config(n_embd=config["n_embd"], n_layer=config["n_layer"],
                     n_head=config["n_head"],
                     n_positions=config["n_positions"],
                     vocab_size=config["vocab_size"])
    with torch.device(device):
        model = GPT2Model(cfg)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    params = {n for n, _ in model.named_parameters()}
    if unexpected or params & set(missing):
        raise ValueError(f"GPT-2 weights do not match the model: missing "
                         f"{sorted(params & set(missing))}, unexpected "
                         f"{sorted(unexpected)}")
    return model.eval()


class Job:
    def __init__(self, cell):
        from litcoder_core_torch import (
            AbstractTrainer, Downsampler, NestedCVModel,
            SimpleNeuroidAssembly, StoryData)
        from litcoder_core_torch.features.language_model import (
            LanguageModelFeatureExtractor)

        self.cell = cell
        c, p = cell.config, cell.params
        dev = torch.device(cell.device)
        self.dev = dev
        self.grid = alpha_grid(c)
        self.block = p["block"]
        self.delays = list(c["fir_delays"])
        self.stories = lebel_stories(cell.seed, c["trainer_stories"],
                                     c["trs_per_story"],
                                     c["tr_seconds"], p["words_per_story"],
                                     p["vocab_size"], c["lookback"])
        self.weights = gpt2_weights(cell.seed, dev, c["n_embd"], c["n_layer"],
                                    c["n_positions"], c["vocab_size"])
        self.ids = {s.name: token_ids(s) for s in self.stories}
        self.responses = self._responses()

        self.results_dir = tempfile.mkdtemp(prefix="cardbench-")
        model = _build_model(c, self.weights, dev)
        story_data = [StoryData(
            name=s.name, brain_data=self.responses[s.name].cpu().numpy(),
            stimuli=s.windows, split_indices=s.split.tolist(),
            tr_times=s.tr_times, data_times=s.data_times,
            word_rates=np.bincount(s.split, minlength=len(s.tr_times))
            .astype(np.float32), words=s.words) for s in self.stories]
        self.extractor = LanguageModelFeatureExtractor({
            "model_name": "gpt2-random-init", "model": model,
            "tokenizer": StubTokenizer(), "device": cell.device,
            "batch_size": p["batch_size"], "last_token": True})
        self.extractor.activation_cache = NoActivationCache()
        self.trainer = AbstractTrainer(
            assembly=SimpleNeuroidAssembly(story_data,
                                           validation_method="outer"),
            feature_extractors=[self.extractor], downsampler=Downsampler(),
            model=NestedCVModel(seed=cell.seed, device=cell.device),
            fir_delays=self.delays, trimming_config=dict(LEBEL_TRIM),
            use_train_test_split=True, layer_idx=c["layer_idx"],
            lookback=c["lookback"], dataset_type="lebel",
            logger_backend="none", results_dir=self.results_dir,
            downsample_config={"method": "lanczos", "window": 3,
                               "cutoff_mult": 1.0},
            device=cell.device)
        structure = self.trainer.structure_data
        self._design = None

        def structure_and_keep(delayed):
            data = structure(delayed)
            self._design = (data["Rstim"], data["Pstim"])
            return data

        self.trainer.structure_data = structure_and_keep
        self._ref = None
        self._r_cache: Dict[bytes, np.ndarray] = {}

    # ---- the traffic ----

    def _reference_features(self, tf32_on: bool) -> Dict[str, torch.Tensor]:
        c = self.cell.config
        with tf32(tf32_on), torch.no_grad():
            return {s.name: ref_gpt2.last_token_features(
                self.weights, self.ids[s.name], c["layer_idx"], c["n_layer"],
                c["n_head"]) for s in self.stories}

    def _designs(self, features, tf32_on: bool) -> Dict[str, torch.Tensor]:
        with tf32(tf32_on):
            return {s.name: ref_lanczos.lanczos_fir(
                features[s.name],
                torch.as_tensor(s.data_times, device=self.dev),
                torch.as_tensor(s.tr_times, device=self.dev), self.delays)
                for s in self.stories}

    def _responses(self) -> Dict[str, torch.Tensor]:
        c, p = self.cell.config, self.cell.params
        gen = torch.Generator(device=self.dev).manual_seed(
            int(self.cell.seed) + 1)
        d, rank, v = c["n_embd"], p["signal_rank"], c["n_voxels"]
        proj = torch.randn((d, rank), device=self.dev, generator=gen)
        mix = torch.randn((rank * len(self.delays), v), device=self.dev,
                          generator=gen) / (rank * len(self.delays)) ** 0.5
        wte = self.weights["wte.weight"]
        words = {s.name: torch.as_tensor([w[-1] for w in self.ids[s.name]],
                                         device=self.dev)
                 for s in self.stories}
        out = {}
        with tf32(False):
            designs = self._designs(
                {n: wte[i] @ proj for n, i in words.items()}, False)
            for s in self.stories:
                z = ref_lebel.zscore_columns(designs[s.name])
                signal = (z @ mix)[10:len(s.tr_times) - 5]
                noise = torch.randn(signal.shape, device=self.dev,
                                    generator=gen)
                out[s.name] = signal + p["noise_std"] * noise
        return out

    # ---- the program ----

    def build_seconds(self) -> float:
        if self.dev.type != "cuda":
            return 0.0
        from litcoder_core_torch.ops import lanczos_fir as lf
        return float(lf.build()[1]["seconds"])

    def run_once(self) -> Dict:
        from litcoder_core_torch.ops import lanczos_fir as lf

        counts = dict(self.extractor.counts)
        launches = lf.launches
        metrics = self.trainer.train(**self.cell.params["train"])
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        Rstim, Pstim = self._design
        self._design = None
        return {
            "outputs": {
                "alphas": np.asarray(metrics["best_alphas"], np.float32),
                "r": np.asarray(metrics["correlations"], np.float32),
                "p": np.asarray(metrics["p_values"], np.float64),
                "q": np.asarray(metrics["corrected_p_values"], np.float64),
                "design": (Rstim.cpu().numpy(), Pstim.cpu().numpy()),
                "route": metrics["solver_paths"]},
            "program": {
                "stage_seconds": dict(metrics["trainer_stage_seconds"]),
                "counts": {k: self.extractor.counts[k] - counts[k]
                           for k in counts},
                "launches": lf.launches - launches}}

    def release(self) -> None:
        self.trainer = self.extractor = None
        shutil.rmtree(self.results_dir, ignore_errors=True)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference, and the control in its place ----

    def _fit_inputs(self, designs):
        order = [s.name for s in self.stories]
        return ref_lebel.structure(designs, self.responses, order)

    def _folds(self, n_rows: int):
        c = self.cell.config
        return ref_folds.chunked_folds(n_rows, c["n_inner_folds"],
                                       c["chunk_length"], self.cell.seed)

    def reference(self, tf32_on: bool = False) -> Dict:
        features = self._reference_features(tf32_on)
        X, Y, Xte, Yte = self._fit_inputs(self._designs(features, tf32_on))
        with tf32(tf32_on):
            scores = ref_ridge.search_scores(X, Y, self._folds(X.shape[0]),
                                             self.grid, self.block)
        return {"inputs": (X, Y, Xte, Yte), "scores": scores.cpu().numpy(),
                "chosen": ref_ridge.best_alphas(scores, self.grid, False)}

    def control_outputs(self) -> Dict:
        ref = self.reference(tf32_on=True)
        X, Y, Xte, Yte = ref["inputs"]
        with tf32(True):
            r = ref_ridge.refit_r(X, Y, Xte, Yte, ref["chosen"],
                                  self.block).cpu().numpy()
        p = ref_stats.pearson_pvalues(r, Xte.shape[0])
        return {"alphas": ref["chosen"], "r": r, "p": p,
                "q": ref_stats.bh_adjust(p),
                "design": (X.cpu().numpy(), Xte.cpu().numpy()),
                "route": None}

    def numbers(self, out: Dict, ref: Dict) -> Dict[str, float]:
        X, Y, Xte, Yte = ref["inputs"]
        key = out["alphas"].tobytes()
        if key not in self._r_cache:
            with tf32(False):
                self._r_cache[key] = ref_ridge.refit_r(
                    X, Y, Xte, Yte, out["alphas"], self.block).cpu().numpy()
        nums = compare.train_test_numbers(out, ref["scores"], self.grid,
                                          self._r_cache[key], Xte.shape[0])
        got_tr, got_te = out["design"]
        nums["design_gap"] = max(
            compare.widest_gap(got_tr, X.cpu().numpy()),
            compare.widest_gap(got_te, Xte.cpu().numpy()))
        if out["route"] is not None:
            nums["route"] = float(out["route"] != self.cell.params["route"])
        return nums

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

    # ---- for the metric readers (metrics/_counts.py) ----

    def lm_flops(self) -> float:
        c = self.cell.config
        return sum(_counts.lm_flops(ids, c["n_embd"], c["n_layer"])
                   for ids in self.ids.values())

    def flops(self) -> float:
        """One train(): the LM forwards and the fit (the kernel's share is
        under a millionth)."""
        c = self.cell.config
        n_tr = len(self.stories[0].tr_times)
        t = (len(self.stories) - 1) * (n_tr - 15)
        folds = self._folds(t)
        return self.lm_flops() + _counts.train_test_flops(
            t, n_tr - 55, c["n_features"], c["n_voxels"], self.grid.size,
            _counts.fold_sizes(folds), _counts.covers_all_rows(folds, t))

    def kernel_counts(self) -> List:
        """(bytes, operations) of each fused Lanczos + FIR launch of one
        train(), one per story."""
        c = self.cell.config
        out = []
        for s in self.stories:
            K = ref_lanczos.lanczos_matrix(torch.as_tensor(s.data_times),
                                           torch.as_tensor(s.tr_times))
            out.append(_counts.lanczos_fir_counts(
                int((K != 0).sum()), len(s.data_times), len(s.tr_times),
                c["n_embd"], len(self.delays)))
        return out
