"""DeepSeek-V2's forward pass in plain float32 torch, up to one hidden
state: the benchmark's copy of the reference (DeepSeek-AI 2024,
arXiv:2405.04434; the published config keys; Hugging Face's weight names).

- RMSNorm: x / sqrt(mean(x^2) + eps) * gain.
- MLA: q = x W_q split per head into no-RoPE and RoPE parts; [c_kv,
  k_rope] = x W_kv_a; c_kv = RMSNorm(c_kv); [k_nope, v] = c_kv W_kv_b per
  head; the RoPE parts of q and the one k_rope shared by the heads rotated
  by position, adjacent pairs (2i, 2i + 1) at YaRN's inverse frequency i;
  scores q . k * (nope + rope)^-1/2 * mscale(factor, mscale_all_dim)^2,
  masked above the diagonal, softmax, times v; o_proj.
- MoE: softmax of x W_gate over the experts, greedy top k, weights times
  routed_scaling_factor (not renormalised: norm_topk_prob is false); each
  expert down(silu(gate x) * up x) on the tokens routed to it (boolean
  masks, one expert after another), weighted and summed; plus the shared
  experts, one SwiGLU of width n_shared x moe width.
- x += attn(RMSNorm(x)); x += mlp(RMSNorm(x)); the first
  first_k_dense_replace MLPs dense. hidden_states[i] is the stream before
  layer i (0: the embeddings).

Every matmul goes through `mm` (default a float32 matmul; TF32 is the
caller's, off in the benchmark): the control passes one that rounds both
operands to float8 first (the attention's batched products as one tensor
each).

Departures from a one-window-at-a-time loop, for memory and time only:
the layers run one after another over every window of a story (each
layer's weights upcast to float32 once, then freed); windows of equal
token length run together (no padding, so only the causal mask); the
MLPs run over the story's tokens in blocks, since they act token by token.
"""

import math
from typing import Callable, Dict, List

import numpy as np
import torch

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _mscale(scale: float, m: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def rope_tables(c: Dict, length: int, device):
    """cos, sin (length, rope / 2) float32: YaRN's blend of interpolated
    and extrapolated frequencies over its correction range."""
    dim, base = c["qk_rope_head_dim"], float(c["rope_theta"])
    freq = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64)
                          / dim)
    factor_cos = 1.0
    rs = c.get("rope_scaling")
    if rs:
        f = rs["factor"]
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
        freq = freq / f * ramp + freq * (1.0 - ramp)
        factor_cos = _mscale(f, rs["mscale"]) / _mscale(f,
                                                        rs["mscale_all_dim"])
    angles = torch.arange(length, dtype=torch.float64)[:, None] * freq
    return ((torch.cos(angles) * factor_cos).float().to(device),
            (torch.sin(angles) * factor_cos).float().to(device))


def softmax_scale(c: Dict) -> float:
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    rs = c.get("rope_scaling")
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


def _linear(mm: Matmul, x, w):
    return mm(x.reshape(-1, x.shape[-1]), w.T).view(*x.shape[:-1], -1)


def _swiglu(mm, x, w, p):
    gate = _linear(mm, x, w[p + "gate_proj.weight"])
    up = _linear(mm, x, w[p + "up_proj.weight"])
    return _linear(mm, gate * torch.sigmoid(gate) * up,
                   w[p + "down_proj.weight"])


def _attention(mm, x, w, p, c, cos, sin):
    """x (B, L, d) -> (B, L, d)."""
    B, L, _ = x.shape
    H = c["num_attention_heads"]
    nope, rope, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    r = c["kv_lora_rank"]
    q = _linear(mm, x, w[p + "q_proj.weight"]).view(B, L, H, nope + rope)
    ckv = _linear(mm, x, w[p + "kv_a_proj_with_mqa.weight"])
    lat = _rms(ckv[..., :r], w[p + "kv_a_layernorm.weight"], 1e-6)
    kv = _linear(mm, lat, w[p + "kv_b_proj.weight"]).view(B, L, H,
                                                          nope + vd)
    q_rope = _rotate(q[..., nope:], cos[:, None], sin[:, None])
    k_rope = _rotate(ckv[..., r:], cos, sin)[:, :, None].expand(B, L, H,
                                                                rope)
    qh = torch.cat([q[..., :nope], q_rope], -1).transpose(1, 2)
    kh = torch.cat([kv[..., :nope], k_rope], -1).transpose(1, 2)
    vh = kv[..., nope:].transpose(1, 2)
    s = mm(qh, kh.transpose(-1, -2)) * softmax_scale(c)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(a, vh)
    return _linear(mm, o.transpose(1, 2).reshape(B, L, H * vd),
                   w[p + "o_proj.weight"])


def _moe(mm, x, w, p, c):
    """x (T, d) -> (T, d)."""
    scores = torch.softmax(_linear(mm, x, w[p + "gate.weight"]), dim=-1)
    top_w, top_i = torch.topk(scores, c["num_experts_per_tok"], dim=-1)
    top_w = top_w * c["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(c["n_routed_experts"]):
        hit = top_i == e
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        weight = (top_w * hit)[rows].sum(-1)
        out[rows] += weight[:, None] * _swiglu(mm, x[rows], w,
                                               f"{p}experts.{e}.")
    return out + _swiglu(mm, x, w, p + "shared_experts.")


def _layer_weights(weights, i: int) -> Dict[str, torch.Tensor]:
    p = f"layers.{i}."
    return {k: v.float() for k, v in weights.items() if k.startswith(p)}


def hidden_state(weights: Dict[str, torch.Tensor], c: Dict,
                 windows: List[List[int]], layer: int,
                 mm: Matmul = torch.matmul, batch: int = 64,
                 block: int = 1 << 16) -> torch.Tensor:
    """(n_windows, d) float32: hidden_states[layer] at each window's last
    token, for token id lists `windows`; `weights` (any float dtype, on
    the device) under Hugging Face's names."""
    embed = weights["embed_tokens.weight"]
    dev = embed.device
    eps = c["rms_norm_eps"]
    lengths = np.array([len(w) for w in windows])
    groups = []
    for length in np.unique(lengths):
        rows = np.nonzero(lengths == length)[0]
        for lo in range(0, rows.size, batch):
            groups.append(rows[lo:lo + batch])
    streams = [embed[torch.as_tensor(np.array([windows[j] for j in g]),
                                     device=dev)].float() for g in groups]
    tables = {}
    for i in range(layer):
        p = f"layers.{i}."
        w = _layer_weights(weights, i)
        for k, x in enumerate(streams):
            L = x.shape[1]
            if L not in tables:
                tables[L] = rope_tables(c, L, dev)
            cos, sin = tables[L]
            x += _attention(mm, _rms(x, w[p + "input_layernorm.weight"],
                                     eps), w, p + "self_attn.", c, cos, sin)
        moe = i >= c["first_k_dense_replace"]
        start = 0
        while start < len(streams):          # MLPs over blocks of tokens
            stop, tokens = start, 0
            while stop < len(streams) and (stop == start or tokens
                                           + streams[stop][..., 0].numel()
                                           <= block):
                tokens += streams[stop][..., 0].numel()
                stop += 1
            part = torch.cat([s.reshape(-1, s.shape[-1])
                              for s in streams[start:stop]])
            h = _rms(part, w[p + "post_attention_layernorm.weight"], eps)
            h = (_moe(mm, h, w, p + "mlp.", c) if moe
                 else _swiglu(mm, h, w, p + "mlp."))
            lo = 0
            for s in streams[start:stop]:
                n = s[..., 0].numel()
                s += h[lo:lo + n].view(s.shape)
                lo += n
            del part, h
            start = stop
        del w
    out = torch.zeros((len(windows), embed.shape[1]), dtype=torch.float32,
                      device=dev)
    for g, x in zip(groups, streams):
        out[torch.as_tensor(g, device=dev)] = x[:, -1]
    return out


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to float8_e4m3fn first, each
    scaled per tensor so its largest magnitude maps to 448, the format's
    largest: the control's precision, below the stated bfloat16."""
    def rounded(t):
        scale = t.abs().amax().clamp(min=1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    return rounded(a) @ rounded(b)
