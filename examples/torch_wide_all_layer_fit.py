"""All-layer JOINT fit, a wide design (D > T) through the dual solver, on
the PyTorch port (twin of examples/wide_all_layer_fit.py).

Concatenating EVERY layer of a language model into one design asks "what
does the whole network predict jointly?" and makes the design WIDE:
n_layers * d_model * n_delays features against a few hundred training
TRs. `method='auto'` detects the shape and runs the dual (kernel-ridge)
Cholesky search (K = X X^T factored instead of the (D, D) Gram).

Offline end to end: a small randomly initialized GPT-2 (the JAX example's
configuration, under torch.manual_seed(0)) and the stub tokenizer stand in
for real checkpoints. main() returns what it prints; its keyword arguments
take another model and larger sizes (GPT2Config(), thousands of words and
tens of thousands of voxels on a card).

Run: python examples/torch_wide_all_layer_fit.py               # the card
     python examples/torch_wide_all_layer_fit.py --device cpu
"""

import argparse
import logging

import numpy as np

TINY_GPT2 = dict(vocab_size=600, n_positions=128, n_embd=64, n_layer=8,
                 n_head=4)
# Rows of the weight matrix drawn at a time: the draws equal one (D, V)
# draw, without holding it in float64 at full width.
DRAW_ROWS = 2048


def _normal_f32(rng, shape, scale, device):
    """scale(rng.normal(size=shape)) cast to float32 on `device`, drawn in
    blocks of rows (the same numbers as one draw)."""
    import torch

    blocks = []
    for lo in range(0, shape[0], DRAW_ROWS):
        rows = min(DRAW_ROWS, shape[0] - lo)
        block = scale(rng.normal(size=(rows,) + shape[1:])).astype(
            np.float32)
        blocks.append(torch.as_tensor(block).to(device))
    return torch.cat(blocks)


def main(argv=None, device="cuda", model=None, n_words=900, n_voxels=512):
    """Every layer of `model` (default: the JAX example's GPT-2 under
    torch.manual_seed(0)) over `n_words` context windows, concatenated,
    Lanczos-downsampled, FIR-delayed, then a dual fit against `n_voxels`
    synthetic responses. Returns the design's shape, the fit's metrics and
    its best alphas."""
    import torch

    from litcoder_core_torch import FIR, fit_nested_cv
    from litcoder_core_torch.downsample import Downsampler
    from litcoder_core_torch.features.language_model import (
        LanguageModelFeatureExtractor,
    )
    from litcoder_core_torch.utils.device import resolve_device
    from litcoder_core_torch.utils.testing import HashStubTokenizer

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=device)
    dev = resolve_device(parser.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # --- extract EVERY layer in one batched pass ------------------------
    if model is None:
        from transformers import GPT2Config, GPT2Model

        torch.manual_seed(0)
        model = GPT2Model(GPT2Config(**TINY_GPT2)).eval()
    extractor = LanguageModelFeatureExtractor({
        "model_name": "tiny-gpt2", "model": model,
        "tokenizer": HashStubTokenizer(), "last_token": True,
        "device": dev,
    })
    words = [f"word{i}" for i in range(n_words)]
    contexts = [" ".join(words[max(0, i - 16):i + 1])
                for i in range(len(words))]
    per_layer = extractor.extract_all_layers(contexts)
    layers = sorted(per_layer)
    feats = np.concatenate([per_layer[i] for i in layers], axis=1)
    print(f"{len(layers)} layers concatenated -> {feats.shape[1]} dims")

    # --- downsample to TRs, FIR-expand: the design goes WIDE ------------
    data_times = np.cumsum(rng.uniform(0.2, 0.5, len(words))).astype(
        np.float32)
    tr = 2.0
    n_trs = int(data_times[-1] / tr)
    tr_times = (np.arange(n_trs, dtype=np.float32) * tr + tr / 2)
    X = Downsampler().downsample(feats, data_times, tr_times,
                                 method="lanczos", window=3, cutoff_mult=1.0,
                                 device=dev)
    X = FIR.make_delayed(X, [1, 2, 3, 4])
    T, D = X.shape
    print(f"design: T={T} TRs x D={D} features (wide: D > T = {D > T})")

    # --- synthetic responses + the dual fit ------------------------------
    V = n_voxels
    wt = _normal_f32(rng, (D, V), lambda z: z / np.sqrt(D), dev)
    noise = _normal_f32(rng, (T, V), lambda z: 0.2 * z, dev)
    Y = X @ wt + noise
    del wt, noise
    split = int(T * 0.8)
    metrics, _, best_alphas = fit_nested_cv(
        X[:split], Y[:split], X_test=X[split:], y_test=Y[split:],
        alphas=np.logspace(-1, 6, 8), n_inner_folds=4, chunk_length=5,
        seed=0, return_weights=False, device=dev,
    )
    # INFO log shows: "alpha search path: dual cholesky (kernel-ridge; ...)"
    n_distinct = int(np.unique(np.asarray(best_alphas)).size)
    print(f"median r = {metrics['median_score']:.3f}, "
          f"{metrics['n_significant']}/{V} significant, "
          f"{n_distinct} distinct alphas selected")
    return {"n_layers": len(layers), "design": (T, D), "wide": D > T,
            "metrics": metrics, "best_alphas": best_alphas,
            "n_distinct_alphas": n_distinct}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
