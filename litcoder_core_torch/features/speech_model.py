"""Speech feature extraction on the card (twin of
litcoder_core_tpu/features/speech_model.py).

Sliding windows of `context_size` seconds at `chunk_size`-second strides
go through a torch speech encoder (a Hugging Face Wav2Vec2, HuBERT or
Whisper model, or any injected module with the same call surface) on
`device`:
- the windows are one strided view of the audio (no n_chunks x context
  copy); each batch of `batch_size` windows is preprocessed on the host by
  the injected Hugging Face feature extractor, exactly as the JAX package
  calls it (normalization for Wav2Vec2/HuBERT, log-mel for Whisper);
- every forward returns all hidden states; layer i is hidden_states[i + 1]
  (the embeddings, hidden_states[0], are excluded), and each of them is
  pooled on the device before the layers are stacked: 'last' takes the
  last encoder frame, 'mean' averages over encoder frames in float32;
- Whisper runs through model.get_encoder(), as the JAX torch path does;
- _PipelinedFetch keeps up to 4 pooled results in flight, copied to pinned
  host memory on a side stream, so the host preprocesses batch k+1 while
  the card runs batch k;
- `mesh`, a ('data', 'model') mesh from parallel.tp.make_lm_mesh: the
  encoder's projections shard Megatron-style over 'model' (parallel/tp.py)
  and window batches split over 'data' groups.

Forwards run in fp32 with TF32 off for matmuls and cuDNN convolutions (the
parity default); dtype='bfloat16' runs them on a bf16 copy of the weights,
made once, and returns fp32 features. Audio is read with soundfile when it
imports, else scipy.io.wavfile, and resampled with scipy's polyphase
filter. `transformers` is imported only where a model is loaded by name.
"""

import copy
import logging
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from litcoder_core_torch.features.base import BaseFeatureExtractor
from litcoder_core_torch.features.language_model import _PipelinedFetch
from litcoder_core_torch.parallel.tp import (
    check_tp_mesh,
    shard_lm_params,
    tp_forward,
)
from litcoder_core_torch.utils.device import matmul_conv_tf32, resolve_device

logger = logging.getLogger(__name__)

_PIPELINE_DEPTH = 4


def load_audio(wav_path: str, target_sample_rate: int = 16000) -> np.ndarray:
    """Mono float32 audio at `target_sample_rate`: integer samples scaled
    to [-1, 1], channels averaged, other rates resampled by
    resample_poly with the rate ratio limited to denominators <= 1000."""
    from fractions import Fraction

    try:
        import soundfile as sf

        data, sr = sf.read(wav_path, dtype="float32", always_2d=True)
        data = data.T  # (channels, n)
    except Exception:
        from scipy.io import wavfile

        sr, raw = wavfile.read(wav_path)
        raw = np.atleast_2d(raw.T if raw.ndim == 2 else raw[None, :])
        if raw.dtype.kind == "i":
            data = raw.astype(np.float32) / float(np.iinfo(raw.dtype).max)
        elif raw.dtype.kind == "u":
            half = (np.iinfo(raw.dtype).max + 1) / 2
            data = (raw.astype(np.float32) - half) / half
        else:
            data = raw.astype(np.float32)
    wav = data.mean(axis=0)
    if sr != target_sample_rate:
        from scipy.signal import resample_poly

        frac = Fraction(target_sample_rate, int(sr)).limit_denominator(1000)
        wav = resample_poly(wav, frac.numerator, frac.denominator).astype(
            np.float32)
    return wav.astype(np.float32)


class SpeechFeatureExtractor(BaseFeatureExtractor):
    """Windowed speech-encoder features on a torch model.

    extract_features(wav_path, layer) -> (features [n_chunks, D], times)
    extract_all_layers(wav_path) -> ({layer: [n_chunks, D]}, times)

    The JAX extractor's arguments, plus `device` ('cuda' when None; without
    a card it raises). The injected model is moved to `device` and put in
    eval mode. `counts` accumulates windows and forwards over the calls;
    `last_stage_seconds` splits the last call into load_s (audio),
    prepare_s (host preprocessing), fetch_wait_s (host waiting on pooled
    results) and forward_total_s (the batch loop, preprocessing
    included).
    """

    def __init__(
        self,
        model_name: str,
        chunk_size: float,
        context_size: float,
        layer: Union[str, int] = "last",
        pool: str = "last",
        device: Optional[str] = None,
        target_sample_rate: int = 16000,
        disable_tqdm: bool = False,
        backend: str = "auto",
        batch_size: int = 8,
        model=None,
        feature_extractor=None,
        mesh=None,
        dtype: str = "float32",
        **_unused,
    ):
        if pool not in {"last", "mean"}:
            raise ValueError("pool must be 'last' or 'mean'")
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
        if backend == "flax":
            raise ValueError(
                "backend='flax' is the JAX package's; litcoder_core_torch "
                "runs torch models (backend 'auto' or 'torch')")
        if backend not in ("auto", "torch"):
            raise ValueError(
                f"backend must be 'auto' or 'torch', got {backend!r}")
        self.config = {
            "model_name": model_name, "chunk_size": chunk_size,
            "context_size": context_size, "pool": pool,
        }
        self.model_name = model_name
        self.chunk_size = float(chunk_size)
        self.context_size = float(context_size)
        self.layer = layer
        self.pool = pool
        self.target_sample_rate = int(target_sample_rate)
        self.disable_tqdm = disable_tqdm
        self.backend = "torch"
        self.batch_size = int(batch_size)
        self.compute_dtype = dtype
        self.device = resolve_device("cuda" if device is None else device)
        self.mesh = check_tp_mesh(mesh, self.device)
        self.counts = {"windows": 0, "forwards": 0}
        self.last_stage_seconds = {}

        self._model = model
        self.feature_extractor = feature_extractor
        if self._model is None:
            self._load_model()
        self._model = self._model.to(self.device).eval()
        self.model_type = getattr(self._model.config, "model_type",
                                  "").lower()
        self._forward_key = (
            "input_features" if self.model_type == "whisper"
            else "input_values")
        # bf16: a second copy of the weights in bf16, made once; the fp32
        # model stays as the caller gave it.
        self._compute_model = self._model
        if self.compute_dtype == "bfloat16":
            self._compute_model = copy.deepcopy(self._model).to(
                torch.bfloat16)
        self._encoder = (self._compute_model.get_encoder()
                         if self.model_type == "whisper"
                         else self._compute_model)
        # A ('data', 'model') mesh: one tensor-parallel copy of the model
        # per 'data' group (cast BEFORE sharding), windows split over the
        # groups with silent pad windows that are dropped before pooling.
        self._tp_encoders = None
        if self.mesh is not None:
            self._tp_encoders = [
                m.get_encoder() if self.model_type == "whisper" else m
                for m in shard_lm_params(self._compute_model, self.mesh)]
        self._input_dtype = (torch.bfloat16 if self.compute_dtype
                             == "bfloat16" else torch.float32)

    def _load_model(self) -> None:
        from transformers import AutoFeatureExtractor, AutoModel

        self.feature_extractor = AutoFeatureExtractor.from_pretrained(
            self.model_name)
        self._model = AutoModel.from_pretrained(self.model_name)

    # ------------------------------------------------------------- windowing

    def _windows(self, wav: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(n_chunks, context_samples) strided windows and their end times:
        window i covers samples [i*chunk, i*chunk + context) and ends at
        (context + i*chunk) / sample rate seconds."""
        chunk = int(self.chunk_size * self.target_sample_rate)
        context = int(self.context_size * self.target_sample_rate)
        total = wav.shape[0]
        if context <= 0 or chunk <= 0:
            raise ValueError(
                "context_size and chunk_size must be > 0 seconds.")
        if total < context:
            return np.empty((0, 0), np.float32), np.array([])
        n_chunks = (total - context) // chunk + 1
        windows = np.lib.stride_tricks.sliding_window_view(
            wav, context)[::chunk][:n_chunks]
        times = ((context + np.arange(n_chunks) * chunk)
                 / self.target_sample_rate)
        return windows, times

    # ---------------------------------------------------------------- forward

    def _prepare_batch(self, windows: np.ndarray) -> np.ndarray:
        """Hugging Face preprocessing (log-mel for Whisper, normalization
        for Wav2Vec2/HuBERT) of a batch of windows, on the host."""
        inputs = self.feature_extractor(
            [w for w in windows],
            sampling_rate=self.target_sample_rate,
            return_tensors="np",
        )
        return np.asarray(inputs[self._forward_key])

    def _forward(self, batch: np.ndarray) -> torch.Tensor:
        """Preprocessed batch -> (L+1, B, D) fp32 pooled states on the
        device; a card gets the batch through pinned memory without
        blocking the host."""
        x = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        x = x.to(self._input_dtype)
        with torch.inference_mode(), matmul_conv_tf32(False):
            if self._tp_encoders is not None:
                hidden = tp_forward(self._tp_encoders, self.mesh, self.device,
                                    {self._forward_key: x},
                                    output_hidden_states=True)
            else:
                hidden = self._encoder(**{self._forward_key: x},
                                       output_hidden_states=True
                                       ).hidden_states
            if self.pool == "last":
                return torch.stack([h[:, -1, :].float() for h in hidden])
            return torch.stack([h.float().mean(dim=1) for h in hidden])

    def _run_all(self, wav_path: str) -> Tuple[np.ndarray, np.ndarray]:
        """All windows through the encoder: (L+1, n_chunks, D), times."""
        t0 = time.perf_counter()
        wav = load_audio(wav_path, self.target_sample_rate)
        windows, times = self._windows(wav)
        stages = {"load_s": time.perf_counter() - t0, "prepare_s": 0.0}
        self.last_stage_seconds = stages
        n = windows.shape[0]
        if n == 0:
            return np.empty((0, 0, 0), np.float32), times
        out = []

        def sink(pooled, lo):
            if not out:
                out.append(np.empty((pooled.shape[0], n, pooled.shape[2]),
                                    np.float32))
            out[0][:, lo:lo + pooled.shape[1]] = pooled

        t0 = time.perf_counter()
        pipe = _PipelinedFetch(_PIPELINE_DEPTH, sink)
        for lo in range(0, n, self.batch_size):
            t1 = time.perf_counter()
            batch = self._prepare_batch(windows[lo:lo + self.batch_size])
            stages["prepare_s"] += time.perf_counter() - t1
            pipe.push(self._forward(batch), lo)
            self.counts["forwards"] += 1
        pipe.flush()
        self.counts["windows"] += n
        stages["fetch_wait_s"] = pipe.fetch_wait_s
        stages["forward_total_s"] = time.perf_counter() - t0
        return out[0], times

    # ------------------------------------------------------------- public API

    def extract_features(self, wav_path: str,
                         layer: Union[str, int, None] = None, **kwargs):
        """Single-layer features: (features [n_chunks, D], times
        [n_chunks])."""
        layer = self.layer if layer is None else layer
        pooled, times = self._run_all(wav_path)
        if pooled.size == 0:
            return np.empty((0, 0)), times
        if layer == "last":
            return pooled[-1], times
        return pooled[int(layer) + 1], times  # hidden_states[0] excluded

    def extract_all_layers(self, wav_path: str, **kwargs):
        """All-layer features: ({layer: [n_chunks, D]}, times)."""
        pooled, times = self._run_all(wav_path)
        if pooled.size == 0:
            return {}, times
        return {li: pooled[li + 1] for li in range(pooled.shape[0] - 1)}, times
