"""Language-model feature extraction on the card (twin of
litcoder_core_tpu/features/language_model.py).

Per-window contexts (one text per word, e.g. fullcontext windows) go
through a torch transformer (a Hugging Face `AutoModel` or any injected
module with the same call surface) on `device`:
- texts are tokenized up front (BOS prepended, no auto-added specials),
  bucketed by padded length and run in batches of `batch_size`, sorted by
  length, exactly as the JAX extractor batches them;
- every forward returns all hidden states (`output_hidden_states=True`);
  layer i is hidden_states[i] (TransformerLens' blocks.i.hook_resid_pre),
  hook_resid_post shifts by one;
- each of the L+1 hidden states is pooled on the device before the layers
  are stacked (last real token, or the masked mean accumulated in fp32), so
  no (L+1, B, T, D) stack is built;
- prefix sharing: windows that are token-prefixes of one another are served
  by one causal forward over the chain's last window, read at each member's
  end position (mean pooling: fp32 cumsum over positions). Exact for the
  decoder-only families of _CAUSAL_MODEL_TYPES;
- _PipelinedFetch keeps up to `pipeline_depth` pooled results in flight,
  each copied to pinned host memory on a side stream, so the host pads and
  enqueues the next batches while the card computes;
- empty strings give zero vectors for every layer;
- config['mesh'], a ('data', 'model') mesh from parallel.tp.make_lm_mesh:
  the attention and MLP projections shard Megatron-style over 'model'
  (parallel/tp.py), batch rows split over 'data' groups (padded with
  all-zero-mask rows, which are dropped before pooling).

fp32 forwards run with TF32 off (the parity default); dtype='bfloat16'
runs the forward on a bf16 copy of the weights, made once (a model whose
floating weights are all bf16 already runs as it is), and returns fp32
features. `transformers` is imported only where a model is loaded by
name. A checkpoint whose config says model_type 'deepseek_v2' loads into
the port's own DeepSeek-V2 module (features/deepseek_v2.py), which a
tensor-parallel mesh refuses; every other family loads through AutoModel.

Spans (utils.profiling.annotate): `litcoder.lm.tokenize` (count windows),
`litcoder.lm.dispatch` per batch (pad, bucket, enqueue; counts windows,
real_tokens, padded_tokens), `litcoder.lm.fetch_wait` (the host's
wait for a result; inside a dispatch when the queue is full, else in the
final flush) and `litcoder.lm.collect` (the pooled layers copied into
the returned arrays). `last_stage_seconds` takes tokenize_s and
fetch_wait_s from those spans' clock readings.
"""

import copy
import logging
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from litcoder_core_torch.features.base import BaseFeatureExtractor
from litcoder_core_torch.features.deepseek_v2 import (
    checkpoint_config,
    is_deepseek_v2,
    load_deepseek_v2,
)
from litcoder_core_torch.parallel.tp import (
    check_tp_mesh,
    shard_lm_params,
    tp_forward,
)
from litcoder_core_torch.utils.device import matmul_conv_tf32, resolve_device
from litcoder_core_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)

_VALID_CONTEXT_TYPES = ["fullcontext", "nocontext", "halfcontext"]

# Decoder-only (strictly causal) model families for which the prefix-sharing
# fast path is numerically exact: position t's hidden state depends only on
# tokens[0:t+1].
_CAUSAL_MODEL_TYPES = {
    "gpt2", "gptj", "gpt_neo", "gpt_neox", "opt", "bloom", "codegen",
    "falcon", "llama", "mistral", "mixtral", "gemma", "gemma2", "phi",
    "phi3", "qwen2", "stablelm", "xglm", "mpt", "pythia", "deepseek_v2",
}


def _all_bf16(model: torch.nn.Module) -> bool:
    """Whether every floating parameter of `model` is bf16 already."""
    floats = [p for p in model.parameters() if p.is_floating_point()]
    return bool(floats) and all(p.dtype == torch.bfloat16 for p in floats)


def _pad_to_bucket(n: int, granularity: int = 32, minimum: int = 32) -> int:
    """Round a token length up to a bucket size (few distinct shapes)."""
    return max(minimum, ((n + granularity - 1) // granularity) * granularity)


def _find_prefix_chains(
    token_lists: List[List[int]], min_chain: int = 4
) -> Tuple[List[List[int]], List[int]]:
    """Split windows (in stimulus order) into prefix chains and singletons.

    A chain is a maximal run i..j where each window's token ids are a prefix
    of the next window's (the fullcontext growth pattern before the lookback
    budget truncates, and every nocontext/halfcontext segment). Chains
    shorter than `min_chain` are returned as singleton indices (the batched
    path handles them).
    """
    chains: List[List[int]] = []
    singles: List[int] = []
    i, n = 0, len(token_lists)
    while i < n:
        j = i
        while (
            j + 1 < n
            and len(token_lists[j]) <= len(token_lists[j + 1])
            and token_lists[j + 1][: len(token_lists[j])] == token_lists[j]
        ):
            j += 1
        members = list(range(i, j + 1))
        if len(members) >= min_chain:
            chains.append(members)
        else:
            singles.extend(members)
        i = j + 1
    return chains, singles


class _PipelinedFetch:
    """Bounded in-flight queue of pooled results on their way to the host.

    CUDA launches are asynchronous, so the host can pad and enqueue batches
    k+1..k+depth while batch k computes. Each pushed result is copied to
    pinned host memory with a non-blocking copy on a side stream that waits
    on an event recorded after the forward; only when more than `depth`
    results are in flight does the host wait, on the oldest copy's event.
    `fetch_wait_s` sums the host time spent waiting (the
    `litcoder.lm.fetch_wait` spans). CPU results are handed over as they
    are.
    """

    def __init__(self, depth: int, sink):
        self._queue = deque()
        self._depth = max(1, int(depth))
        self._sink = sink  # sink(np_result, meta) -> None
        self._stream = None
        self.fetch_wait_s = 0.0

    def push(self, pooled: torch.Tensor, meta) -> None:
        if pooled.is_cuda:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=pooled.device)
            ready = torch.cuda.Event()
            ready.record()
            host = torch.empty(pooled.shape, dtype=pooled.dtype,
                               pin_memory=True)
            with torch.cuda.stream(self._stream):
                self._stream.wait_event(ready)
                host.copy_(pooled, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._stream)
            # `pooled` stays referenced until its copy is drained, so the
            # allocator cannot hand its memory to a later forward early.
            self._queue.append((host, done, pooled, meta))
        else:
            self._queue.append((pooled, None, None, meta))
        if len(self._queue) > self._depth:
            self._drain_one()

    def _drain_one(self) -> None:
        host, done, _, meta = self._queue.popleft()
        with annotate("litcoder.lm.fetch_wait") as span:
            if done is not None:
                done.synchronize()
            arr = host.numpy()
        self.fetch_wait_s += span.seconds
        self._sink(arr, meta)

    def flush(self) -> None:
        while self._queue:
            self._drain_one()


class LanguageModelFeatureExtractor(BaseFeatureExtractor):
    """Batched all-layer LM feature extractor on a torch model.

    Config keys (those of the JAX extractor): model_name (str, required),
    layer_idx (int), hook_type ('hook_resid_pre' | 'hook_resid_post'),
    last_token (bool), context_type, backend ('auto' | 'torch'),
    batch_size (int), pipeline_depth (int), dtype ('float32' |
    'bfloat16'), prefix_sharing ('auto' | True | False), model / tokenizer
    (optional injected instances; the model is moved to `device` and put in
    eval mode); and `device` ('cuda' by default; without a card it raises).
    `counts` accumulates windows, forwards (chains and singles) and real and
    padded tokens over the extractor's calls.
    """

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.model_name = config["model_name"]
        self.layer_idx = config.get("layer_idx", -1)
        self.hook_type = config.get("hook_type", "hook_resid_pre")
        self.last_token = config.get("last_token", True)
        self.context_type = config.get("context_type", "fullcontext")
        self.batch_size = int(config.get("batch_size", 64))
        self.pipeline_depth = int(config.get("pipeline_depth", 4))
        # Host-side stage split of the last extract_* call: tokenize_s,
        # fetch_wait_s, forward_total_s, host_prep_s.
        self.last_stage_seconds: Dict[str, float] = {}
        self.compute_dtype = config.get("dtype", "float32")
        self.prefix_sharing = config.get("prefix_sharing", "auto")
        self.counts = {"windows": 0, "chain_forwards": 0,
                       "single_forwards": 0, "real_tokens": 0,
                       "padded_tokens": 0}

        backend = config.get("backend", "auto")
        if backend == "flax":
            raise ValueError(
                "backend='flax' is the JAX package's; litcoder_core_torch "
                "runs torch models (backend 'auto' or 'torch')"
            )
        if backend not in ("auto", "torch"):
            raise ValueError(
                f"backend must be 'auto' or 'torch', got {backend!r}")
        self.backend = "torch"
        self.device = resolve_device(config.get("device", "cuda"))
        self.mesh = check_tp_mesh(config.get("mesh"), self.device)

        self._model = config.get("model")
        self._tokenizer = config.get("tokenizer")
        if self._model is None or self._tokenizer is None:
            self._load_model()
        if self.mesh is not None and is_deepseek_v2(self._model):
            raise ValueError(
                "a tensor-parallel mesh cannot shard DeepSeek-V2: MLA "
                "(kv_b_proj, the shared RoPE key) and MoE (routed and shared "
                "experts) sharding is unsupported; run it without 'mesh'")
        self._model = self._model.to(self.device).eval()
        self._configure_dims()
        # bf16: a second copy of the weights in bf16, made once; the fp32
        # model stays as the caller gave it. A model already in bf16 is
        # not copied.
        self._compute_model = self._model
        if self.compute_dtype == "bfloat16" and not _all_bf16(self._model):
            self._compute_model = copy.deepcopy(self._model).to(
                torch.bfloat16)
        # A ('data', 'model') mesh: one tensor-parallel copy per 'data'
        # group, made from the compute model (cast BEFORE sharding, so a
        # bf16 run holds bf16 shards).
        self._tp_models = (None if self.mesh is None
                           else shard_lm_params(self._compute_model,
                                                self.mesh))

    # ------------------------------------------------------------------ setup

    def _load_model(self) -> None:
        from transformers import AutoModel, AutoTokenizer

        self._tokenizer = AutoTokenizer.from_pretrained(self.model_name)
        model_type = checkpoint_config(self.model_name).get("model_type")
        if model_type == "deepseek_v2":
            self._model = load_deepseek_v2(self.model_name)
        else:
            self._model = AutoModel.from_pretrained(self.model_name)

    def _configure_dims(self) -> None:
        cfg = self._model.config
        self.d_model = int(
            getattr(cfg, "hidden_size", None) or getattr(cfg, "n_embd", 0)
        )
        self.n_layers = int(
            getattr(cfg, "num_hidden_layers", None) or getattr(cfg, "n_layer", 0)
        )

    # --------------------------------------------------------------- tokenize

    def _encode(self, text: str) -> List[int]:
        try:
            # No auto-added specials: tokenizers that add their own BOS/EOS
            # (llama etc.) would otherwise double the BOS below or make
            # last-token pooling read an EOS state.
            ids = self._tokenizer.encode(text, add_special_tokens=False)
        except TypeError:  # plain callables / stub tokenizers
            ids = self._tokenizer.encode(text)
        bos = self._tokenizer.bos_token_id
        # TransformerLens prepend_bos=True parity: every sequence starts
        # with exactly one BOS.
        if bos is not None:
            ids = [bos] + ids
        return ids

    # ---------------------------------------------------------------- forward

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """int64 host array -> tensor on the device; a card gets it through
        pinned memory without blocking the host."""
        t = torch.from_numpy(array)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _hidden_states(self, ids: torch.Tensor, mask: torch.Tensor):
        with torch.inference_mode(), matmul_conv_tf32(False):
            if self._tp_models is not None:
                # Rows pad to the 'data' extent with all-zero masks; the
                # pad rows are dropped here, before any pooling reads them.
                return tp_forward(self._tp_models, self.mesh, self.device,
                                  {"input_ids": ids, "attention_mask": mask},
                                  output_hidden_states=True)
            out = self._compute_model(input_ids=ids, attention_mask=mask,
                                      output_hidden_states=True)
        return out.hidden_states

    def _forward(self, ids_np: np.ndarray, mask_np: np.ndarray
                 ) -> torch.Tensor:
        """(B, T) ids and mask -> (L+1, B, D) fp32 pooled states on the
        device."""
        ids, mask = self._to_device(ids_np), self._to_device(mask_np)
        hidden = self._hidden_states(ids, mask)
        with torch.inference_mode(), matmul_conv_tf32(False):
            if self.last_token:
                idx = torch.clamp(mask.sum(dim=-1) - 1, min=0)
                rows = torch.arange(ids.shape[0], device=self.device)
                pooled = torch.stack([h[rows, idx].float() for h in hidden])
            else:
                m = mask.float()
                den = m.sum(dim=-1).clamp(min=1.0)[:, None]
                pooled = torch.stack([
                    torch.einsum("btd,bt->bd", h.float(), m) / den
                    for h in hidden
                ])
        return pooled

    def _chain_forward(self, ids_np: np.ndarray, mask_np: np.ndarray,
                       pos_np: np.ndarray) -> torch.Tensor:
        """One forward over each chain-final sequence -> (L+1, B, K, D):
        the pooled feature of the member ending at token position p is read
        at p (last token: hidden_states[:, b, p]; mean: the cumulative mean
        over positions 0..p, every prefix token being real). `pos` is
        (B, K), padded by repeating a valid position."""
        ids, mask = self._to_device(ids_np), self._to_device(mask_np)
        pos = self._to_device(pos_np)
        hidden = self._hidden_states(ids, mask)
        with torch.inference_mode():
            rows = torch.arange(ids.shape[0], device=self.device)[:, None]
            if self.last_token:
                pooled = torch.stack([h[rows, pos].float() for h in hidden])
            else:
                denom = (pos + 1).float()[:, :, None]
                pooled = torch.stack([
                    torch.cumsum(h.float(), dim=1)[rows, pos] / denom
                    for h in hidden
                ])
        return pooled

    def _prefix_sharing_enabled(self) -> bool:
        if self.prefix_sharing in (True, False):
            return bool(self.prefix_sharing)
        model_type = getattr(self._model.config, "model_type", "")
        return model_type in _CAUSAL_MODEL_TYPES

    def _run_chain_batches(self, token_lists, chains, pooled_all,
                           pad_id) -> None:
        """Prefix-chain path: one forward per chain-final sequence, so all
        members of a chain cost one forward. Chains are grouped by padded
        length and batched; member positions are gathered on the device."""
        batches: Dict[int, List[List[int]]] = {}
        for chain in chains:
            bucket = _pad_to_bucket(len(token_lists[chain[-1]]))
            batches.setdefault(bucket, []).append(chain)

        def sink(pooled, batch):
            # pooled: (L+1, B, K, D); padded gathers are never read.
            for row, chain in enumerate(batch):
                pooled_all[:, chain, :] = pooled[:, row, :len(chain), :]

        pipe = _PipelinedFetch(self.pipeline_depth, sink)
        for bucket, group in batches.items():
            for s in range(0, len(group), self.batch_size):
                batch = group[s:s + self.batch_size]
                with annotate("litcoder.lm.dispatch") as span:
                    kmax = _pad_to_bucket(max(len(c) for c in batch),
                                          granularity=8, minimum=8)
                    b = len(batch)
                    ids = np.full((b, bucket), pad_id, np.int64)
                    mask = np.zeros((b, bucket), np.int64)
                    pos = np.zeros((b, kmax), np.int64)
                    for row, chain in enumerate(batch):
                        final = token_lists[chain[-1]][:bucket]
                        ids[row, :len(final)] = final
                        mask[row, :len(final)] = 1
                        ends = [min(len(token_lists[j]), bucket) - 1
                                for j in chain]
                        pos[row, :len(chain)] = ends
                        pos[row, len(chain):] = ends[-1]  # padded gathers
                    self._count_batch(span, "chain_forwards",
                                      sum(len(c) for c in batch), mask)
                    pipe.push(self._chain_forward(ids, mask, pos), batch)
        pipe.flush()
        self.last_stage_seconds["fetch_wait_s"] = round(
            self.last_stage_seconds.get("fetch_wait_s", 0.0)
            + pipe.fetch_wait_s, 4)

    def _count_batch(self, span: annotate, forwards: str, windows: int,
                     mask: np.ndarray) -> None:
        """One batch's forward and tokens, in `counts` and its span's."""
        real, padded = int(mask.sum()), mask.size
        self.counts[forwards] += 1
        self.counts["real_tokens"] += real
        self.counts["padded_tokens"] += padded
        span.counts.update(windows=windows, real_tokens=real,
                           padded_tokens=padded)

    def _tokenize_timed(self, stimuli, nonempty) -> List[List[int]]:
        with annotate("litcoder.lm.tokenize", windows=len(nonempty)) as span:
            token_lists = [self._encode(stimuli[i]) for i in nonempty]
        self.last_stage_seconds = {
            "tokenize_s": round(span.seconds, 4),
            "fetch_wait_s": 0.0,
        }
        return token_lists

    def _run_batches(self, token_lists: List[List[int]]) -> np.ndarray:
        """Run all nonempty token lists; returns (n_layers+1, N, D)."""
        t0 = time.perf_counter_ns()
        n = len(token_lists)
        self.counts["windows"] += n
        pooled_all = np.zeros(
            (self.n_layers + 1, n, self.d_model), np.float32
        )
        pad_id = (self._tokenizer.pad_token_id
                  or self._tokenizer.eos_token_id or 0)

        singles = list(range(n))
        if self._prefix_sharing_enabled():
            chains, singles = _find_prefix_chains(token_lists)
            if chains:
                logger.info(
                    "prefix sharing: %d windows collapse into %d forwards",
                    sum(len(c) for c in chains), len(chains),
                )
                self._run_chain_batches(token_lists, chains, pooled_all,
                                        pad_id)

        n_single = len(singles)
        order = sorted(singles, key=lambda i: len(token_lists[i]))

        def sink(pooled, batch_idx):
            pooled_all[:, batch_idx, :] = pooled

        pipe = _PipelinedFetch(self.pipeline_depth, sink)
        i = 0
        while i < n_single:
            batch_idx = order[i:i + self.batch_size]
            with annotate("litcoder.lm.dispatch") as span:
                max_len = max(len(token_lists[j]) for j in batch_idx)
                bucket = _pad_to_bucket(max_len)
                ids = np.full((len(batch_idx), bucket), pad_id, np.int64)
                mask = np.zeros((len(batch_idx), bucket), np.int64)
                for row, j in enumerate(batch_idx):
                    toks = token_lists[j][:bucket]
                    ids[row, :len(toks)] = toks
                    mask[row, :len(toks)] = 1
                self._count_batch(span, "single_forwards", len(batch_idx),
                                  mask)
                pipe.push(self._forward(ids, mask), batch_idx)
            i += self.batch_size
        pipe.flush()
        self.last_stage_seconds["fetch_wait_s"] = round(
            self.last_stage_seconds.get("fetch_wait_s", 0.0)
            + pipe.fetch_wait_s, 4)
        total = (time.perf_counter_ns() - t0) / 1e9
        self.last_stage_seconds["forward_total_s"] = round(total, 4)
        # Everything the host did while NOT blocked on the device:
        # tokenize happened earlier; this is pad/bucket/dispatch/writeback.
        self.last_stage_seconds["host_prep_s"] = round(
            total - self.last_stage_seconds["fetch_wait_s"], 4)
        return pooled_all

    # ------------------------------------------------------------- public API

    def extract_all_layers(self, stimuli: Union[str, List[str]],
                           **kwargs) -> Dict[int, np.ndarray]:
        """All-layer features: {layer_idx: (n_texts, d_model)} float32.

        Layer i is TransformerLens `blocks.i.hook_resid_pre`, HF
        hidden_states[i] (hook_resid_post shifts by one)."""
        if isinstance(stimuli, str):
            stimuli = [stimuli]
        n = len(stimuli)
        nonempty = [i for i, t in enumerate(stimuli) if t != ""]
        logger.info("Extracting all layers for %d texts (%d nonempty)",
                    n, len(nonempty))

        hs_offset = 1 if self.hook_type == "hook_resid_post" else 0
        out = {
            layer: np.zeros((n, self.d_model), np.float32)
            for layer in range(self.n_layers)
        }
        if nonempty:
            token_lists = self._tokenize_timed(stimuli, nonempty)
            pooled = self._run_batches(token_lists)  # (L+1, N, D)
            with annotate("litcoder.lm.collect"):
                for layer in range(self.n_layers):
                    out[layer][nonempty] = pooled[layer + hs_offset]
        return out

    def extract_features(self, stimuli: Union[str, List[str]],
                         layer_idx: Optional[int] = None,
                         **kwargs) -> np.ndarray:
        """Single-layer features (n_texts, d_model) float32."""
        if layer_idx is None:
            layer_idx = self.layer_idx
        layer_idx = self._resolve_layer(layer_idx)
        if isinstance(stimuli, str):
            stimuli = [stimuli]
        n = len(stimuli)
        nonempty = [i for i, t in enumerate(stimuli) if t != ""]
        hs_offset = 1 if self.hook_type == "hook_resid_post" else 0
        out = np.zeros((n, self.d_model), np.float32)
        if nonempty:
            token_lists = self._tokenize_timed(stimuli, nonempty)
            pooled = self._run_batches(token_lists)
            with annotate("litcoder.lm.collect"):
                out[nonempty] = pooled[layer_idx + hs_offset]
        return out

    def _resolve_layer(self, layer_idx: int) -> int:
        """Normalize a block index to [0, n_layers): negatives count from the
        end like Python indexing (-1 = last block). Out-of-range raises:
        indexing hidden_states with a negative would silently return a
        different representation (e.g. the final layer norm's output)."""
        resolved = layer_idx + self.n_layers if layer_idx < 0 else layer_idx
        if not 0 <= resolved < self.n_layers:
            raise ValueError(
                f"layer_idx {layer_idx} out of range for a "
                f"{self.n_layers}-block model"
            )
        return resolved

    # ------------------------------------------------------------- validation

    def _validate_config(self) -> None:
        if "model_name" not in self.config:
            raise ValueError("Missing required parameter: model_name")
        if "layer_idx" in self.config and not isinstance(
            self.config["layer_idx"], int
        ):
            raise ValueError("layer_idx must be an integer")
        if "context_type" in self.config:
            if self.config["context_type"] not in _VALID_CONTEXT_TYPES:
                raise ValueError(
                    f"context_type must be one of {_VALID_CONTEXT_TYPES}"
                )
        if self.config.get("dtype", "float32") not in ("float32",
                                                       "bfloat16"):
            raise ValueError(
                "dtype must be 'float32' or 'bfloat16', got "
                f"{self.config['dtype']!r}"
            )
