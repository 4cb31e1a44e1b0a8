"""GPT-2 weights drawn on the device from a seed.

The names and shapes are Hugging Face GPT2Model's (Conv1D weights are
(in, out)). All of them come from one draw of a generator on the device,
split into views: matrices and biases N(0, 0.02^2), layer-norm gains
1 + N(0, 0.02^2) and their shifts N(0, 0.02^2). Every parameter is random, so
the check sees every one of them used.
"""

from typing import Dict, List, Tuple

import torch


def parameter_shapes(n_embd: int, n_layer: int, n_positions: int,
                     vocab_size: int) -> List[Tuple[str, Tuple[int, ...]]]:
    d = n_embd
    shapes = [("wte.weight", (vocab_size, d)),
              ("wpe.weight", (n_positions, d))]
    for i in range(n_layer):
        p = f"h.{i}."
        shapes += [
            (p + "ln_1.weight", (d,)), (p + "ln_1.bias", (d,)),
            (p + "attn.c_attn.weight", (d, 3 * d)),
            (p + "attn.c_attn.bias", (3 * d,)),
            (p + "attn.c_proj.weight", (d, d)), (p + "attn.c_proj.bias", (d,)),
            (p + "ln_2.weight", (d,)), (p + "ln_2.bias", (d,)),
            (p + "mlp.c_fc.weight", (d, 4 * d)),
            (p + "mlp.c_fc.bias", (4 * d,)),
            (p + "mlp.c_proj.weight", (4 * d, d)),
            (p + "mlp.c_proj.bias", (d,)),
        ]
    shapes += [("ln_f.weight", (d,)), ("ln_f.bias", (d,))]
    return shapes


def gpt2_weights(seed: int, device, n_embd: int, n_layer: int,
                 n_positions: int, vocab_size: int,
                 std: float = 0.02) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`}, views of one seeded draw."""
    shapes = parameter_shapes(n_embd, n_layer, n_positions, vocab_size)
    total = sum(torch.Size(s).numel() for _, s in shapes)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    flat = torch.randn(total, device=dev, generator=gen).mul_(std)
    out, lo = {}, 0
    for name, shape in shapes:
        n = torch.Size(shape).numel()
        t = flat[lo:lo + n].view(shape)
        if name.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight")):
            t.add_(1.0)
        out[name] = t
        lo += n
    return out
