"""DeepSeek-V2 weights drawn on the device from a seed, in bfloat16.

The names and shapes are Hugging Face DeepseekV2Model's (nn.Linear weights
are (out, in)). One generator on the device draws tensor after tensor in
bfloat16: matrices N(0, 0.02^2), RMSNorm gains 1 + N(0, 0.02^2), so no
float32 copy of the model is ever held. Each routed expert's projections
are tensors of their own, as DeepSeek's checkpoints ship them.
"""

from typing import Dict, List, Tuple

import torch


def _mlp(prefix: str, hidden: int, width: int):
    return [(prefix + "gate_proj.weight", (width, hidden)),
            (prefix + "up_proj.weight", (width, hidden)),
            (prefix + "down_proj.weight", (hidden, width))]


def parameter_shapes(c: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every tensor of a checkpoint of the config `c`."""
    h, heads = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    shapes = [("embed_tokens.weight", (c["vocab_size"], h))]
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        shapes += [
            (p + "input_layernorm.weight", (h,)),
            (p + "self_attn.q_proj.weight", (heads * qk, h)),
            (p + "self_attn.kv_a_proj_with_mqa.weight",
             (c["kv_lora_rank"] + c["qk_rope_head_dim"], h)),
            (p + "self_attn.kv_a_layernorm.weight", (c["kv_lora_rank"],)),
            (p + "self_attn.kv_b_proj.weight",
             (heads * (c["qk_nope_head_dim"] + c["v_head_dim"]),
              c["kv_lora_rank"])),
            (p + "self_attn.o_proj.weight", (h, heads * c["v_head_dim"])),
            (p + "post_attention_layernorm.weight", (h,)),
        ]
        if is_moe_layer(c, i):
            shapes += [(p + "mlp.gate.weight", (c["n_routed_experts"], h))]
            for e in range(c["n_routed_experts"]):
                shapes += _mlp(f"{p}mlp.experts.{e}.", h,
                               c["moe_intermediate_size"])
            shapes += _mlp(p + "mlp.shared_experts.", h,
                           c["moe_intermediate_size"]
                           * c["n_shared_experts"])
        else:
            shapes += _mlp(p + "mlp.", h, c["intermediate_size"])
    shapes.append(("norm.weight", (h,)))
    return shapes


def is_moe_layer(c: Dict, i: int) -> bool:
    return bool(c["n_routed_experts"]) and i >= c["first_k_dense_replace"] \
        and i % c.get("moe_layer_freq", 1) == 0


def deepseek_v2_weights(seed: int, device, c: Dict,
                        std: float = 0.02) -> Dict[str, torch.Tensor]:
    """{name: bfloat16 tensor on `device`} for the config `c` (the
    published keys)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {}
    for name, shape in parameter_shapes(c):
        t = torch.randn(shape, device=dev, generator=gen,
                        dtype=torch.bfloat16).mul_(std)
        if name.endswith("norm.weight"):
            t.add_(1.0)
        out[name] = t
    return out
