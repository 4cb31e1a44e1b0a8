"""DeepSeek-V2's forward pass in plain float32 torch, one sequence at a
time: the reference the port's module is held to on the CPU.

Written from the paper (DeepSeek-AI 2024, DeepSeek-V2, arXiv:2405.04434,
section 2.1 multi-head latent attention, 2.2 DeepSeekMoE) and the published
config keys (deepseek-ai/DeepSeek-V2-Lite config.json): weights under
Hugging Face's names, a config as a plain dict.

- RMSNorm: x / sqrt(mean(x^2) + eps) * gain.
- MLA: q = x W_q (heads x (nope + rope)); [c_kv, k_rope] = x W_kv_a;
  c_kv = RMSNorm(c_kv); [k_nope, v] = c_kv W_kv_b per head; the rope parts
  of q and the one shared k_rope rotated by position, adjacent pairs
  (2i, 2i + 1) at inverse frequency i (YaRN's blend when rope_scaling is
  yarn); scores = q . k * scale, scale = (nope + rope)^-1/2 *
  mscale(factor, mscale_all_dim)^2, masked above the diagonal to -inf,
  softmax, times v; o_proj.
- MoE: softmax of x W_gate over the experts, the top k (greedy), weights
  not renormalised (norm_topk_prob false) times routed_scaling_factor;
  each expert down(silu(gate x) * up x) on the tokens routed to it
  (boolean masks, one expert after another), weighted and summed; plus
  the shared experts, one SwiGLU of width n_shared x moe width.
- Layers: x += attn(RMSNorm(x)); x += mlp(RMSNorm(x)); the first
  first_k_dense_replace MLPs dense. hidden_states[0] is the embedding,
  [i] the stream after layer i, the last one through the final RMSNorm.

Departures from DeepSeek's published code: none in the arithmetic. It
computes in float32 (the checkpoint is bf16), the RoPE angles in float64,
keeps no KV cache, and knows only DeepSeek-V2-Lite's settings (q_lora_rank
null, greedy top-k, norm_topk_prob false). TF32 is off for every matmul.

Imports torch and math alone.
"""

import math
from typing import Dict, List

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _mscale(scale: float, m: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def _inv_freq(cfg: Dict):
    dim, base = cfg["qk_rope_head_dim"], float(cfg.get("rope_theta", 1e4))
    freq = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    rs = cfg.get("rope_scaling")
    if not rs:
        return freq, 1.0
    factor = rs["factor"]
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    freq = freq / factor * ramp + freq * (1.0 - ramp)
    cos_factor = _mscale(factor, rs["mscale"]) / _mscale(
        factor, rs["mscale_all_dim"])
    return freq, cos_factor


def softmax_scale(cfg: Dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        scale *= _mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def _rms(x, g, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * g


def _rotate(x, cos, sin):
    a, b = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = a * cos - b * sin
    out[..., 1::2] = a * sin + b * cos
    return out


def _swiglu(x, w, p):
    gate = x @ w[p + "gate_proj.weight"].T
    up = x @ w[p + "up_proj.weight"].T
    return (gate * torch.sigmoid(gate) * up) @ w[p + "down_proj.weight"].T


def _attention(x, w, p, cfg, cos, sin):
    T = x.shape[0]
    H = cfg["num_attention_heads"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    q = (x @ w[p + "q_proj.weight"].T).view(T, H, nope + rope)
    ckv = x @ w[p + "kv_a_proj_with_mqa.weight"].T
    c, k_rope = ckv[:, :r], ckv[:, r:]
    c = _rms(c, w[p + "kv_a_layernorm.weight"], 1e-6)
    kv = (c @ w[p + "kv_b_proj.weight"].T).view(T, H, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_rope = _rotate(q[..., nope:], cos[:, None], sin[:, None])
    k_rope = _rotate(k_rope, cos, sin)
    scale = softmax_scale(cfg)
    mask = torch.ones(T, T, dtype=torch.bool).tril()
    out = torch.empty(T, H, vd)
    for h in range(H):
        qh = torch.cat([q[:, h, :nope], q_rope[:, h]], dim=-1)
        kh = torch.cat([k_nope[:, h], k_rope], dim=-1)
        s = (qh @ kh.T) * scale
        s = s.masked_fill(~mask, float("-inf"))
        out[:, h] = torch.softmax(s, dim=-1) @ v[:, h]
    return out.reshape(T, H * vd) @ w[p + "o_proj.weight"].T


def _moe(x, w, p, cfg):
    scores = torch.softmax(x @ w[p + "gate.weight"].T, dim=-1)
    k = cfg["num_experts_per_tok"]
    top_w, top_i = torch.topk(scores, k, dim=-1)
    top_w = top_w * cfg.get("routed_scaling_factor", 1.0)
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        hit = top_i == e                       # (T, k)
        rows = hit.any(-1)
        if not rows.any():
            continue
        weight = (top_w * hit).sum(-1)[rows]
        out[rows] += weight[:, None] * _swiglu(x[rows], w,
                                               f"{p}experts.{e}.")
    if cfg.get("n_shared_experts"):
        out = out + _swiglu(x, w, p + "shared_experts.")
    return out


def hidden_states(weights: Dict[str, torch.Tensor], cfg: Dict,
                  ids: List[int]) -> List[torch.Tensor]:
    """num_hidden_layers + 1 float32 tensors (T, hidden) for one sequence
    of token ids."""
    w = {k: v.float() for k, v in weights.items()}
    eps = cfg.get("rms_norm_eps", 1e-6)
    T = len(ids)
    freq, cos_factor = _inv_freq(cfg)
    angles = torch.arange(T, dtype=torch.float64)[:, None] * freq[None]
    cos = (torch.cos(angles) * cos_factor).float()
    sin = (torch.sin(angles) * cos_factor).float()
    x = w["embed_tokens.weight"][torch.as_tensor(ids)]
    out = [x]
    dense = cfg.get("first_k_dense_replace", 0)
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        x = x + _attention(_rms(x, w[p + "input_layernorm.weight"], eps), w,
                           p + "self_attn.", cfg, cos, sin)
        h = _rms(x, w[p + "post_attention_layernorm.weight"], eps)
        x = x + (_swiglu(h, w, p + "mlp.") if i < dense
                 else _moe(h, w, p + "mlp.", cfg))
        out.append(x)
    out[-1] = _rms(x, w["norm.weight"], eps)
    return out
