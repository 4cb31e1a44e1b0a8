"""GPT-2's forward pass in plain torch, up to one hidden state.

Radford et al. 2019 as Hugging Face's GPT2Model computes it: token plus
position embeddings; each block a pre-layer-norm causal self-attention
(one (d, 3d) projection split into queries, keys and values, heads of
d / n_head, scores scaled by 1 / sqrt(head size), softmax over the allowed
positions) and a pre-layer-norm MLP of width 4d with the tanh GELU, each
added to the residual stream; layer norms with eps 1e-5. hidden_states[i]
is the stream before block i (i = 0: the embeddings); after the last block
it is the final layer norm of it. Conv1D weights are (in, out).

Departure from a one-window-at-a-time loop: windows of equal token length
are run together as one batch (no padding, so no attention mask beyond the
causal one).
"""

import math
from typing import Dict, List

import numpy as np
import torch


def _layer_norm(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def hidden_state(weights: Dict[str, torch.Tensor], ids: torch.Tensor,
                 layer: int, n_layer: int, n_head: int) -> torch.Tensor:
    """hidden_states[layer] (B, L, d) for token ids (B, L)."""
    w = weights
    B, L = ids.shape
    h = w["wte.weight"][ids] + w["wpe.weight"][:L][None]
    d = h.shape[-1]
    hd = d // n_head
    causal = torch.ones(L, L, dtype=torch.bool, device=ids.device).tril()
    for i in range(min(layer, n_layer)):
        p = f"h.{i}."
        a = _layer_norm(h, w[p + "ln_1.weight"], w[p + "ln_1.bias"])
        qkv = a @ w[p + "attn.c_attn.weight"] + w[p + "attn.c_attn.bias"]
        q, k, v = (t.reshape(B, L, n_head, hd).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, L, d)
        h = h + o @ w[p + "attn.c_proj.weight"] + w[p + "attn.c_proj.bias"]
        m = _layer_norm(h, w[p + "ln_2.weight"], w[p + "ln_2.bias"])
        m = _gelu_tanh(m @ w[p + "mlp.c_fc.weight"] + w[p + "mlp.c_fc.bias"])
        h = h + m @ w[p + "mlp.c_proj.weight"] + w[p + "mlp.c_proj.bias"]
    if layer >= n_layer:
        h = _layer_norm(h, w["ln_f.weight"], w["ln_f.bias"])
    return h


def last_token_features(weights: Dict[str, torch.Tensor],
                        windows: List[List[int]], layer: int, n_layer: int,
                        n_head: int, batch: int = 64) -> torch.Tensor:
    """(n_windows, d): hidden_states[layer] at each window's last token."""
    d = weights["wte.weight"].shape[1]
    dev = weights["wte.weight"].device
    out = torch.zeros((len(windows), d), dtype=torch.float32, device=dev)
    lengths = np.array([len(w) for w in windows])
    for length in np.unique(lengths):
        rows = np.nonzero(lengths == length)[0]
        for lo in range(0, rows.size, batch):
            sel = rows[lo:lo + batch]
            ids = torch.as_tensor(np.array([windows[j] for j in sel]),
                                  dtype=torch.int64, device=dev)
            h = hidden_state(weights, ids, layer, n_layer, n_head)
            out[torch.as_tensor(sel, device=dev)] = h[:, -1]
    return out
