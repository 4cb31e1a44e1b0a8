"""Operations and bytes of DeepSeek-V2's forwards, counted from shapes and
token counts (the published config keys).

- lm_flops: 2 x the parameters a token multiplies by (embeddings out;
  MLA's four projections; the dense MLP, or the router, the shared
  experts and num_experts_per_tok routed experts), times the real tokens
  a causal model must run (metrics/_counts.lm_tokens: a chain of windows
  each a prefix of the next runs as its last window), plus attention:
  QK^T over qk_nope + qk_rope and AV over v_head_dim, each head, over the
  L (L + 1) / 2 allowed pairs of each layer.
- expert_gemm_counts: one MoE layer's grouped GEMMs over R = tokens x k
  routed rows: gate and up together (hidden -> 2 width), then down (width
  -> hidden), 6 R hidden width operations; bytes, bf16, each read once and
  each written once: the sorted rows in, the (R, 2 width) product out, the
  (R, width) activation in, the (R, hidden) product out, and the weights
  of every expert that received a row.
"""

from typing import Dict, List, Tuple

import numpy as np

from cardbench.metrics._counts import lm_tokens

BF16 = 2


def active_params(c: Dict) -> Tuple[int, int]:
    """(parameters a token multiplies by, layers), embeddings left out."""
    h, heads = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    r = c["kv_lora_rank"]
    mla = (h * heads * qk + h * (r + c["qk_rope_head_dim"])
           + r * heads * (c["qk_nope_head_dim"] + c["v_head_dim"])
           + heads * c["v_head_dim"] * h)
    width = c["moe_intermediate_size"]
    dense = 3 * h * c["intermediate_size"]
    moe = (c["n_routed_experts"] * h
           + 3 * h * width * c["n_shared_experts"]
           + c["num_experts_per_tok"] * 3 * h * width)
    n = c["num_hidden_layers"]
    k = c["first_k_dense_replace"]
    return n * mla + k * dense + (n - k) * moe, n


def lm_flops(windows: List[List[int]], c: Dict) -> float:
    params, n = active_params(c)
    per_pair = 2 * c["num_attention_heads"] * (
        c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"])
    lengths = np.asarray(lm_tokens(windows), np.float64)
    return float(2.0 * params * lengths.sum()
                 + n * per_pair * (lengths * (lengths + 1) / 2).sum())


def expert_gemm_counts(tokens: int, experts_hit: int,
                       c: Dict) -> Tuple[float, float]:
    """(bytes, operations) of one MoE layer's routed-expert GEMMs."""
    h, width = c["hidden_size"], c["moe_intermediate_size"]
    rows = tokens * c["num_experts_per_tok"]
    ops = 2.0 * rows * h * 2 * width + 2.0 * rows * width * h
    moved = rows * (h + 2 * width + width + h)
    weights = experts_hit * 3 * h * width
    return BF16 * float(moved + weights), ops
