"""DeepSeek-V2's decoder (DeepSeek-AI 2024, arXiv:2405.04434), for the LM
extractor.

A base model (no LM head) with Hugging Face's state-dict names and call
surface, so a checkpoint's state dict loads into it and
LanguageModelFeatureExtractor runs it like any AutoModel:

- built from a plain dict of the published config keys or from a
  transformers DeepseekV2Config (building it imports no transformers);
- `model(input_ids, attention_mask, output_hidden_states=True)` returns
  `.hidden_states`, num_hidden_layers + 1 entries (the embeddings, each
  layer's output, the last one through the final RMSNorm) and
  `.last_hidden_state`; `.config.model_type` is 'deepseek_v2'.

Each layer is a pre-RMSNorm multi-head latent attention (MLA) and a
pre-RMSNorm SwiGLU MLP, each added to the residual stream; the first
`first_k_dense_replace` MLPs are dense, the rest mixtures of experts.

MLA: queries from `q_proj` (q_lora_rank null, as DeepSeek-V2-Lite has
it); the latent c_kv = RMSNorm(x W_kv_a[:, :kv_lora_rank]),
the keys' no-RoPE part and the values from kv_b_proj(c_kv), one RoPE key of
qk_rope_head_dim shared by every head from the last columns of W_kv_a.
RoPE rotates adjacent pairs (2i, 2i + 1) with YaRN's interpolated inverse
frequencies when rope_scaling says 'yarn'. The softmax scale is DeepSeek's
published one, qk_head_dim^-1/2 times yarn_get_mscale(factor,
mscale_all_dim)^2 (about 1.590 for DeepSeek-V2-Lite); transformers'
DeepseekV2Attention (4.57) leaves the mscale^2 out. Attention runs through
scaled_dot_product_attention, causal only: callers pad on the right, so
every real position attends to real positions alone (the padded ones are
computed and never read).

MoE: router logits and softmax in float32, greedy top-k (k =
num_experts_per_tok), the weights not renormalised (norm_topk_prob false)
and times routed_scaling_factor. Each layer holds its routed experts as
two stacked tensors (DeepseekV2Experts: gate and up together, then down),
stacked once, as a state dict loads. Tokens are sorted by expert on the
device, each projection is one GEMM over the sorted rows, and the
weighted combine (ops/moe_combine.py) sums each token's k rows in float32,
in slot order, into its row in the input's dtype; the shared experts add
their output. The GEMM and the combine differ by device: on a CUDA device
one torch._grouped_mm in bfloat16 (expert_gemm) and the hand-written
combine kernel, nothing in the forward waiting for the device, and
anything else there refused; on the CPU a loop over the experts' row
ranges and the combine's plain version.

Spans (utils.profiling.annotate): `litcoder.lm.mla` per attention call;
`litcoder.lm.moe` per MoE layer with counts tokens (rows routed, padding
included), real_tokens, max_expert_tokens (the most rows any expert
got) and experts_hit (the experts that got any; the last three device
tensors, read when the record is read); its children
`litcoder.lm.moe.experts` around the routed experts' GEMMs and
`litcoder.lm.moe.combine` around the inverse permutation and the combine,
with counts rows (N k), tokens (N) and fused (1 where the kernel ran, 0 on
the CPU).
"""

import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from litcoder_core_torch.ops.moe_combine import inverse_order, moe_combine
from litcoder_core_torch.utils.profiling import annotate

MODEL_TYPE = "deepseek_v2"

# DeepseekV2Config's defaults for the keys a published config may omit.
_DEFAULTS = {
    "q_lora_rank": None, "n_shared_experts": None, "n_routed_experts": None,
    "routed_scaling_factor": 1.0, "topk_method": "greedy",
    "norm_topk_prob": False, "first_k_dense_replace": 0,
    "moe_layer_freq": 1, "hidden_act": "silu", "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "rope_scaling": None, "attention_bias": False,
    "scoring_func": "softmax", "pad_token_id": None,
}
_REQUIRED = ("vocab_size", "hidden_size", "intermediate_size",
             "moe_intermediate_size", "num_hidden_layers",
             "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim",
             "qk_rope_head_dim", "v_head_dim", "num_experts_per_tok")


class DeepseekV2Settings:
    """The published config keys as attributes (model_type 'deepseek_v2').

    `source` is a dict of config.json's keys or any object with them as
    attributes (a transformers DeepseekV2Config)."""

    model_type = MODEL_TYPE

    def __init__(self, source: Any):
        if not isinstance(source, dict):
            source = (source.to_dict() if hasattr(source, "to_dict")
                      else vars(source))
        missing = [k for k in _REQUIRED if source.get(k) is None]
        if missing:
            raise ValueError(f"DeepSeek-V2 config lacks {missing}")
        values = dict(_DEFAULTS)
        values.update({k: v for k, v in source.items()
                       if k in _DEFAULTS or k in _REQUIRED})
        for key, value in values.items():
            setattr(self, key, value)
        if self.hidden_act != "silu" or self.scoring_func != "softmax":
            raise ValueError("DeepSeek-V2 runs SiLU MLPs and a softmax "
                             f"router; got {self.hidden_act!r}, "
                             f"{self.scoring_func!r}")
        if self.n_routed_experts and (self.topk_method != "greedy"
                                      or self.norm_topk_prob):
            raise ValueError(
                f"topk_method {self.topk_method!r}, norm_topk_prob "
                f"{self.norm_topk_prob!r}: only DeepSeek-V2-Lite's greedy "
                "top-k with unnormalised weights is supported")
        if self.q_lora_rank is not None:
            raise ValueError("q_lora_rank: only DeepSeek-V2-Lite's "
                             "uncompressed queries are supported")
        self.qk_head_dim = self.qk_nope_head_dim + self.qk_rope_head_dim


def yarn_get_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's attention temperature factor, as DeepSeek's code defines it."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_scaling(cfg: DeepseekV2Settings) -> Optional[Dict[str, Any]]:
    rs = cfg.rope_scaling
    if not rs:
        return None
    kind = rs.get("rope_type", rs.get("type"))
    if kind != "yarn":
        raise ValueError(f"rope_scaling type {kind!r}: only 'yarn' is "
                         "supported")
    return rs


def softmax_scale(cfg: DeepseekV2Settings) -> float:
    """qk_head_dim^-1/2, times yarn_get_mscale(factor, mscale_all_dim)^2
    under YaRN (DeepSeek's published scale)."""
    scale = cfg.qk_head_dim ** -0.5
    rs = _yarn_scaling(cfg)
    if rs and rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale *= m * m
    return scale


def rope_inv_freq(cfg: DeepseekV2Settings) -> Tuple[torch.Tensor, float]:
    """(inverse frequencies (qk_rope_head_dim / 2,) float32, the factor on
    cos and sin): plain RoPE, or YaRN's blend of interpolated and
    extrapolated frequencies over its correction range."""
    dim, base = cfg.qk_rope_head_dim, float(cfg.rope_theta)
    cpu = torch.device("cpu")     # whatever device a build runs under
    pos = base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                device=cpu) / dim)
    rs = _yarn_scaling(cfg)
    if rs is None:
        return 1.0 / pos, 1.0
    factor = float(rs["factor"])
    original = rs.get("original_max_position_embeddings") or 4096
    beta_fast = rs.get("beta_fast") or 32
    beta_slow = rs.get("beta_slow") or 1

    def correction_dim(rotations):
        return (dim * math.log(original / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=cpu) - low)
            / (high - low)).clamp(0, 1)
    extrapolate = 1.0 - ramp
    inv = (1.0 / (factor * pos)) * ramp + (1.0 / pos) * extrapolate
    mscale = rs.get("mscale") or 0
    mscale_all = rs.get("mscale_all_dim") or 0
    attn = (yarn_get_mscale(factor, mscale) / yarn_get_mscale(factor,
                                                               mscale_all)
            if mscale and mscale_all else yarn_get_mscale(factor))
    return inv, float(attn)


def _rotate_pairs(x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent pairs (2i, 2i + 1) of the last dim by the angles of
    cos, sin (L, dim / 2), in float32; returns x's dtype."""
    pairs = x.float().unflatten(-1, (-1, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    out = torch.stack((a * cos - b * sin, a * sin + b * cos), dim=-1)
    return out.flatten(-2).to(x.dtype)


class DeepseekV2RMSNorm(nn.Module):
    """Normalised in float32, cast back, then scaled by the gain."""

    def __init__(self, size: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.variance_epsilon = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True)
                            + self.variance_epsilon)
        return self.weight * h.to(x.dtype)


class DeepseekV2MLP(nn.Module):
    """down(silu(gate(x)) * up(x))."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, width, bias=False)
        self.up_proj = nn.Linear(hidden, width, bias=False)
        self.down_proj = nn.Linear(width, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DeepseekV2Attention(nn.Module):
    """Multi-head latent attention with a decoupled, shared RoPE key."""

    def __init__(self, cfg: DeepseekV2Settings):
        super().__init__()
        self.cfg = cfg
        h, heads = cfg.hidden_size, cfg.num_attention_heads
        bias = bool(cfg.attention_bias)
        self.q_proj = nn.Linear(h, heads * cfg.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(
            h, cfg.kv_lora_rank + cfg.qk_rope_head_dim, bias=bias)
        self.kv_a_layernorm = DeepseekV2RMSNorm(cfg.kv_lora_rank)
        self.kv_b_proj = nn.Linear(
            cfg.kv_lora_rank,
            heads * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False)
        self.o_proj = nn.Linear(heads * cfg.v_head_dim, h, bias=bias)
        self.scale = softmax_scale(cfg)

    def forward(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, L, _ = x.shape
        heads, nope, rope = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                             cfg.qk_rope_head_dim)
        with annotate("litcoder.lm.mla"):
            q = self.q_proj(x).view(B, L, heads,
                                    cfg.qk_head_dim).transpose(1, 2)
            q_nope, q_pe = q.split([nope, rope], dim=-1)
            c_kv, k_pe = self.kv_a_proj_with_mqa(x).split(
                [cfg.kv_lora_rank, rope], dim=-1)
            kv = self.kv_b_proj(self.kv_a_layernorm(c_kv)).view(
                B, L, heads, nope + cfg.v_head_dim).transpose(1, 2)
            k_nope, v = kv.split([nope, cfg.v_head_dim], dim=-1)
            q_pe = _rotate_pairs(q_pe, cos, sin)
            k_pe = _rotate_pairs(k_pe.view(B, 1, L, rope), cos, sin)
            q = torch.cat((q_nope, q_pe), dim=-1)
            k = torch.cat((k_nope, k_pe.expand(B, heads, L, rope)), dim=-1)
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               scale=self.scale)
            return self.o_proj(o.transpose(1, 2).reshape(B, L, -1))


def stack_experts(state: Dict[str, torch.Tensor], prefix: str,
                  n_experts: int) -> None:
    """Replace one layer's per-expert tensors in `state` (`{prefix}{e}.
    gate_proj.weight`, `up_proj`, `down_proj`, as DeepSeek's checkpoints
    ship them) by the two stacked ones DeepseekV2Experts holds, in place,
    each expert's tensors dropped as it is copied; nothing where they are
    not there."""
    first = state.get(prefix + "0.gate_proj.weight")
    if first is None:
        return
    width, hidden = first.shape
    gate_up = first.new_empty((n_experts, 2 * width, hidden))
    down = first.new_empty((n_experts, hidden, width))
    for e in range(n_experts):
        p = f"{prefix}{e}."
        gate_up[e, :width].copy_(state.pop(p + "gate_proj.weight"))
        gate_up[e, width:].copy_(state.pop(p + "up_proj.weight"))
        down[e].copy_(state.pop(p + "down_proj.weight"))
    state[prefix + "gate_up_proj"] = gate_up
    state[prefix + "down_proj"] = down


class DeepseekV2Experts(nn.Module):
    """The routed experts as two stacked tensors, the layout a grouped GEMM
    reads: gate_up_proj (E, 2 width, hidden), each expert's gate rows then
    its up rows, and down_proj (E, hidden, width). Its state dict names
    each expert's tensors as Hugging Face does (`{e}.gate_proj.weight`,
    views of the stacks), and such a state dict loads into it, stacked as
    it loads (stack_experts)."""

    def __init__(self, n_experts: int, hidden: int, width: int):
        super().__init__()
        self.gate_up_proj = nn.Parameter(
            torch.empty(n_experts, 2 * width, hidden))
        self.down_proj = nn.Parameter(torch.empty(n_experts, hidden, width))
        self.register_load_state_dict_pre_hook(
            lambda module, state, prefix, *_: stack_experts(
                state, prefix, n_experts))
        self.register_state_dict_post_hook(self._per_expert)

    @staticmethod
    def _per_expert(module, state, prefix, local_metadata) -> None:
        gate_up = state.pop(prefix + "gate_up_proj")
        down = state.pop(prefix + "down_proj")
        width = down.shape[2]
        for e in range(gate_up.shape[0]):
            p = f"{prefix}{e}."
            state[p + "gate_proj.weight"] = gate_up[e, :width]
            state[p + "up_proj.weight"] = gate_up[e, width:]
            state[p + "down_proj.weight"] = down[e]


def _grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                  ends: torch.Tensor) -> torch.Tensor:
    return torch._grouped_mm(x, w.transpose(1, 2), offs=ends)


def _looped_gemm(x: torch.Tensor, w: torch.Tensor,
                 ends: torch.Tensor) -> torch.Tensor:
    out = x.new_empty((x.shape[0], w.shape[1]))
    start = 0
    for g, end in enumerate(ends.tolist()):
        out[start:end] = x[start:end] @ w[g].T
        start = end
    return out


def expert_gemm(device: torch.device, dtype: torch.dtype):
    """The routed experts' GEMM for tensors on `device` of `dtype`:
    gemm(x (N, in), w (G, out, in), ends (G,) int32) -> (N, out), the rows
    of group g, x[ends[g - 1]:ends[g]], times w[g]^T. On the CPU a loop
    over the groups; on a CUDA device one torch._grouped_mm, which takes
    bfloat16. Anything else raises: a loop on a card would wait for the
    device at every group."""
    if device.type == "cpu":
        return _looped_gemm
    if device.type != "cuda":
        raise ValueError(f"DeepSeek-V2's routed experts run on the CPU or "
                         f"a CUDA device, not {device.type!r}")
    if not hasattr(torch, "_grouped_mm"):
        raise ValueError(f"DeepSeek-V2's routed experts on a CUDA device "
                         f"need torch._grouped_mm, which torch "
                         f"{torch.__version__} lacks")
    if dtype != torch.bfloat16:
        raise ValueError(f"DeepSeek-V2's routed experts on a CUDA device "
                         f"run in bfloat16 (torch._grouped_mm), not "
                         f"{dtype}: give the extractor dtype='bfloat16'")
    return _grouped_gemm


class DeepseekV2MoE(nn.Module):
    """Routed experts (top-k of a softmax router) plus shared experts."""

    def __init__(self, cfg: DeepseekV2Settings):
        super().__init__()
        self.cfg = cfg
        h, width = cfg.hidden_size, cfg.moe_intermediate_size
        self.top_k = cfg.num_experts_per_tok
        self.n_experts = cfg.n_routed_experts
        self.gate = nn.Module()
        self.gate.weight = nn.Parameter(torch.empty(self.n_experts, h))
        self.experts = DeepseekV2Experts(self.n_experts, h, width)
        self.shared_experts = (
            DeepseekV2MLP(h, width * cfg.n_shared_experts)
            if cfg.n_shared_experts else None)

    def route(self, flat: torch.Tensor) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
        """(weights (N, k) float32, expert ids (N, k)) of each row."""
        logits = F.linear(flat.float(), self.gate.weight.float())
        scores = logits.softmax(dim=-1)
        weights, ids = torch.topk(scores, self.top_k, dim=-1, sorted=False)
        return weights * self.cfg.routed_scaling_factor, ids

    def forward(self, x: torch.Tensor,
                real: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L, H = x.shape
        gemm = expert_gemm(x.device, x.dtype)
        with annotate("litcoder.lm.moe", tokens=B * L) as span:
            flat = x.reshape(-1, H)
            weights, ids = self.route(flat)
            routed, ends = self.routed(flat, weights, ids, gemm)
            if span.recording:
                per_expert = torch.diff(ends, prepend=ends.new_zeros(1))
                span.counts.update(
                    real_tokens=(real.sum() if real is not None
                                 else B * L),
                    max_expert_tokens=per_expert.max(),
                    experts_hit=(per_expert > 0).sum())
            out = routed.view(B, L, H)
            if self.shared_experts is not None:
                out = out + self.shared_experts(x)
            return out

    def routed(self, flat: torch.Tensor, weights: torch.Tensor,
               ids: torch.Tensor, gemm) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
        """(the routed experts' weighted sum (N, hidden) in flat's dtype,
        each expert's end in the sorted rows (E,) int32): rows sorted by
        expert on the device, one `gemm` (expert_gemm) per projection over
        them, then moe_combine of each token's k rows, summed in float32."""
        gate_up, down = self.experts.gate_up_proj, self.experts.down_proj
        width = down.shape[2]
        flat_ids = ids.reshape(-1)
        order = torch.argsort(flat_ids, stable=True)
        rows = order // self.top_k
        ends = torch.searchsorted(
            flat_ids[order], torch.arange(self.n_experts,
                                          device=flat.device),
            right=True).to(torch.int32)
        xs = flat[rows]
        with annotate("litcoder.lm.moe.experts"):
            h = gemm(xs, gate_up, ends)
            act = F.silu(h[:, :width]) * h[:, width:]
            ys = gemm(act, down, ends)
        with annotate("litcoder.lm.moe.combine", rows=order.numel(),
                      tokens=flat.shape[0],
                      fused=int(ys.device.type == "cuda")):
            out = moe_combine(ys, inverse_order(order), weights)
        return out, ends


class DeepseekV2DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Settings, index: int):
        super().__init__()
        self.input_layernorm = DeepseekV2RMSNorm(cfg.hidden_size,
                                                 cfg.rms_norm_eps)
        self.self_attn = DeepseekV2Attention(cfg)
        self.post_attention_layernorm = DeepseekV2RMSNorm(cfg.hidden_size,
                                                          cfg.rms_norm_eps)
        moe = (cfg.n_routed_experts and index >= cfg.first_k_dense_replace
               and index % cfg.moe_layer_freq == 0)
        self.mlp = (DeepseekV2MoE(cfg) if moe
                    else DeepseekV2MLP(cfg.hidden_size,
                                       cfg.intermediate_size))

    def forward(self, x, cos, sin, real=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        h = self.post_attention_layernorm(x)
        if isinstance(self.mlp, DeepseekV2MoE):
            return x + self.mlp(h, real)
        return x + self.mlp(h)


class DeepseekV2Output:
    """What the extractor reads of a forward."""

    def __init__(self, last_hidden_state, hidden_states):
        self.last_hidden_state = last_hidden_state
        self.hidden_states = hidden_states


class DeepseekV2Model(nn.Module):
    """DeepSeek-V2's base model with Hugging Face's names (see the module
    docstring). Parameters are allocated, not initialised: load a state
    dict, or build with from_state_dict."""

    def __init__(self, config: Any):
        super().__init__()
        self.config = (config if isinstance(config, DeepseekV2Settings)
                       else DeepseekV2Settings(config))
        cfg = self.config
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DeepseekV2DecoderLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = DeepseekV2RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self._rope = rope_inv_freq(cfg)
        self._rope_cache: Dict[Tuple[int, str], Tuple] = {}

    @classmethod
    def from_state_dict(cls, config: Any,
                        state: Dict[str, torch.Tensor]) -> "DeepseekV2Model":
        """The model (eval, no grad) holding the tensors of `state`, under
        Hugging Face's names, as they are: built on the meta device, each
        MoE layer's experts stacked into `state` in place first, one layer
        after another, so that no more than one layer's are held twice."""
        with torch.device("meta"):
            model = cls(config)
        for i, layer in enumerate(model.layers):
            if isinstance(layer.mlp, DeepseekV2MoE):
                stack_experts(state, f"layers.{i}.mlp.experts.",
                              layer.mlp.n_experts)
        model.load_state_dict(state, strict=True, assign=True)
        return model.eval().requires_grad_(False)

    def _cos_sin(self, length: int, device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
        """cos and sin (length, qk_rope_head_dim / 2) float32 on `device`,
        made once per length and device (on the host, then copied)."""
        key = (length, str(device))
        if key not in self._rope_cache:
            inv_freq, factor = self._rope
            angles = torch.arange(length, dtype=torch.float32)[:, None] \
                * inv_freq[None, :]
            with torch.inference_mode(False):
                self._rope_cache[key] = tuple(
                    (f(angles) * factor).to(device)
                    for f in (torch.cos, torch.sin))
        return self._rope_cache[key]

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                output_hidden_states: bool = False,
                **kwargs) -> DeepseekV2Output:
        """input_ids (B, L); attention_mask (B, L), 1 on real tokens,
        padded on the right (it feeds the real_tokens count; attention is
        causal alone)."""
        backend = torch.backends.cuda.matmul
        saved = backend.allow_bf16_reduced_precision_reduction
        backend.allow_bf16_reduced_precision_reduction = False
        try:
            h = self.embed_tokens(input_ids)
            cos, sin = self._cos_sin(input_ids.shape[1], h.device)
            hidden = [h]
            for layer in self.layers:
                h = layer(h, cos, sin, attention_mask)
                hidden.append(h)
            h = self.norm(h)
        finally:
            backend.allow_bf16_reduced_precision_reduction = saved
        hidden[-1] = h
        return DeepseekV2Output(h, tuple(hidden) if output_hidden_states
                                else None)


def is_deepseek_v2(model: Any) -> bool:
    return getattr(getattr(model, "config", None), "model_type",
                   None) == MODEL_TYPE


def checkpoint_config(name_or_path: str) -> Dict[str, Any]:
    """config.json of a local checkpoint directory or a cached hub name."""
    return json.loads(open(_checkpoint_file(name_or_path,
                                            "config.json")).read())


def _checkpoint_file(name_or_path: str, filename: str,
                     required: bool = True) -> Optional[str]:
    if os.path.isdir(name_or_path):
        path = os.path.join(name_or_path, filename)
        if os.path.isfile(path):
            return path
        if required:
            raise FileNotFoundError(path)
        return None
    from transformers.utils import cached_file

    return cached_file(name_or_path, filename,
                       _raise_exceptions_for_missing_entries=required)


def load_deepseek_v2(name_or_path: str,
                     device="cpu") -> DeepseekV2Model:
    """The port's module holding a checkpoint's weights (safetensors,
    one file or sharded), in the dtype they are stored in. Keys of a
    causal-LM checkpoint ('model.' prefix, lm_head) are mapped to the base
    model's (DeepseekV2Model.from_state_dict)."""
    from safetensors.torch import load_file

    config = checkpoint_config(name_or_path)
    index = _checkpoint_file(name_or_path, "model.safetensors.index.json",
                             required=False)
    if index is not None:
        shards = sorted(set(json.loads(open(index).read())
                            ["weight_map"].values()))
        files = [_checkpoint_file(name_or_path, s) for s in shards]
    else:
        files = [_checkpoint_file(name_or_path, "model.safetensors")]
    state = {}
    for f in files:
        for key, value in load_file(f, device=str(device)).items():
            if key.startswith("lm_head."):
                continue
            state[key[len("model."):] if key.startswith("model.")
                  else key] = value
    return DeepseekV2Model.from_state_dict(config, state)
