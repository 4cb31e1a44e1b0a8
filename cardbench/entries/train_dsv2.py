"""Entry 'train_dsv2': train_lm's job (AbstractTrainer.train() from LeBel-
shaped stories to metrics, one train() per job) with the port's DeepSeek-V2
module as the extractor's model: every published width and layer, weights
drawn on the device in bfloat16 one tensor per expert and projection, as a
checkpoint ships them (traffic/deepseek_v2_weights.py), and loaded as a
checkpoint is (DeepseekV2Model.from_state_dict); the extractor in dtype
'bfloat16', which runs a bf16 model as it is.

params: those of train_lm (words_per_story, vocab_size, batch_size,
signal_rank, noise_std, train, route, block).

The planted signal is built as train_lm builds it, from each word's own
row of embed_tokens. The reference is cardbench/reference/deepseek_v2.py
in float32 on the upcast weights, read back from the model's state dict,
layer by layer. The LM's error, far above the fit's, would hide a fit in
a lower precision, so the fit is also judged alone: the fit_* numbers
hold its alphas, r, p and q against the float32 reference fit on the
design the fit was given. The control (calibrate.py) runs that reference
with every matmul's operands rounded to float8_e4m3fn, per tensor scaled,
a precision below the stated bfloat16, and the downsampling and the fit
with TF32 on, as train_lm's control does: the LM numbers read the float8,
the fit_* numbers the TF32.
"""

import tempfile
from typing import Dict

import numpy as np
import torch

from cardbench import compare
from cardbench.entries import train_lm
from cardbench.entries.fit import alpha_grid
from cardbench.metrics import _counts, _counts_moe
from cardbench.precision import tf32
from cardbench.reference import deepseek_v2 as ref_dsv2
from cardbench.reference import lebel as ref_lebel
from cardbench.reference import ridge as ref_ridge
from cardbench.traffic.deepseek_v2_weights import deepseek_v2_weights
from cardbench.traffic.stories import StubTokenizer, lebel_stories, token_ids


class Job(train_lm.Job):
    def __init__(self, cell):
        # First, so that a program without the module fails at once.
        from litcoder_core_torch.features.deepseek_v2 import DeepseekV2Model
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
                                     c["trs_per_story"], c["tr_seconds"],
                                     p["words_per_story"], p["vocab_size"],
                                     c["lookback"])
        model = DeepseekV2Model.from_state_dict(
            c, deepseek_v2_weights(cell.seed, dev, c))
        if dev.type == "cuda":
            torch.cuda.empty_cache()        # the per-expert draws' blocks
        self.weights = model.state_dict()
        self.ids = {s.name: token_ids(s) for s in self.stories}
        self.responses = self._responses()

        self.results_dir = tempfile.mkdtemp(prefix="cardbench-")
        story_data = [StoryData(
            name=s.name, brain_data=self.responses[s.name].cpu().numpy(),
            stimuli=s.windows, split_indices=s.split.tolist(),
            tr_times=s.tr_times, data_times=s.data_times,
            word_rates=np.bincount(s.split, minlength=len(s.tr_times))
            .astype(np.float32), words=s.words) for s in self.stories]
        self.extractor = LanguageModelFeatureExtractor({
            "model_name": "deepseek-v2-lite-random-init", "model": model,
            "tokenizer": StubTokenizer(), "device": cell.device,
            "batch_size": p["batch_size"], "last_token": True,
            "dtype": "bfloat16"})
        self.extractor.activation_cache = train_lm.NoActivationCache()
        self.trainer = AbstractTrainer(
            assembly=SimpleNeuroidAssembly(story_data,
                                           validation_method="outer"),
            feature_extractors=[self.extractor], downsampler=Downsampler(),
            model=NestedCVModel(seed=cell.seed, device=cell.device),
            fir_delays=self.delays,
            trimming_config=dict(train_lm.LEBEL_TRIM),
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

    def _responses(self) -> Dict[str, torch.Tensor]:
        c, p = self.cell.config, self.cell.params
        gen = torch.Generator(device=self.dev).manual_seed(
            int(self.cell.seed) + 1)
        d, rank, v = c["hidden_size"], p["signal_rank"], c["n_voxels"]
        proj = torch.randn((d, rank), device=self.dev, generator=gen)
        mix = torch.randn((rank * len(self.delays), v), device=self.dev,
                          generator=gen) / (rank * len(self.delays)) ** 0.5
        embed = self.weights["embed_tokens.weight"]
        words = {s.name: torch.as_tensor([w[-1] for w in self.ids[s.name]],
                                         device=self.dev)
                 for s in self.stories}
        out = {}
        with tf32(False):
            designs = self._designs(
                {n: embed[i].float() @ proj for n, i in words.items()},
                False)
            for s in self.stories:
                z = ref_lebel.zscore_columns(designs[s.name])
                signal = (z @ mix)[10:len(s.tr_times) - 5]
                noise = torch.randn(signal.shape, device=self.dev,
                                    generator=gen)
                out[s.name] = signal + p["noise_std"] * noise
        return out

    # ---- the reference, and the control in its place ----

    def _reference_features(self, control: bool) -> Dict[str, torch.Tensor]:
        """The reference's hidden_states[layer_idx] at each window's last
        token; `control` (train_lm's tf32_on) rounds every matmul's
        operands to float8."""
        c = self.cell.config
        mm = ref_dsv2.fp8_matmul if control else torch.matmul
        with tf32(False), torch.no_grad():
            return {s.name: ref_dsv2.hidden_state(
                self.weights, c, self.ids[s.name], c["layer_idx"], mm)
                for s in self.stories}

    def numbers(self, out: Dict, ref: Dict) -> Dict[str, float]:
        nums = super().numbers(out, ref)
        nums.update(self._fit_numbers(out, ref))
        return nums

    def _fit_numbers(self, out: Dict, ref: Dict) -> Dict[str, float]:
        """score_regret, r_gap, p_gap, q_gap as fit_*: the float32
        reference's search and refit on the design that the fit was given
        (out['design']), against the fit's alphas, r, p and q."""
        _, Y, _, Yte = ref["inputs"]
        X, Xte = (torch.as_tensor(d, device=self.dev) for d in out["design"])
        with tf32(False):
            scores = ref_ridge.search_scores(X, Y, self._folds(X.shape[0]),
                                             self.grid, self.block)
            r = ref_ridge.refit_r(X, Y, Xte, Yte, out["alphas"], self.block)
        nums = compare.train_test_numbers(out, scores.cpu().numpy(),
                                          self.grid, r.cpu().numpy(),
                                          Xte.shape[0])
        return {"fit_" + k: v for k, v in nums.items()}

    # ---- for the metric readers ----

    def lm_flops(self) -> float:
        c = self.cell.config
        return sum(_counts_moe.lm_flops(ids, c) for ids in self.ids.values())

    def fit_flops(self) -> float:
        c = self.cell.config
        n_tr = len(self.stories[0].tr_times)
        t = (len(self.stories) - 1) * (n_tr - 15)
        folds = self._folds(t)
        return _counts.train_test_flops(
            t, n_tr - 55, c["n_features"], c["n_voxels"], self.grid.size,
            _counts.fold_sizes(folds), _counts.covers_all_rows(folds, t))

    def flops(self) -> float:
        """One train(): the LM forwards and the fit."""
        return self.lm_flops() + self.fit_flops()
