"""Tensor-parallel feature extraction and a device-resident trainer on the
PyTorch port (twin of examples/tp_extraction.py).

End to end on synthetic data (no downloads):

1. a language model whose projections are sharded Megatron-style over a
   2-D ('data', 'model') mesh (`litcoder_core_torch.parallel.tp`): the
   route to extracting features from models larger than one card;
2. a trainer whose fused Lanczos+FIR stage (`fused_downsample_fir='auto'`,
   the CUDA kernel on a card) keeps its output on the device through
   z-scoring, trimming and stacking.

By default the mesh holds every card of the machine (8 entries of the CPU
with --device cpu, as the JAX example's virtual devices); a mesh may
repeat a device:

    python examples/torch_tp_extraction.py               # the cards
    python examples/torch_tp_extraction.py --device cpu

main() returns what it prints.
"""

import argparse

import numpy as np

TINY_GPT2 = dict(vocab_size=600, n_positions=128, n_embd=32, n_layer=2,
                 n_head=2)
CPU_MESH_ENTRIES = 8


def make_assembly(n_stories=3, n_trs=80, n_vox=64, seed=0):
    from litcoder_core_torch import SimpleNeuroidAssembly, StoryData

    rng = np.random.default_rng(seed)
    weights = rng.normal(size=(4, n_vox)).astype(np.float32)
    stories = []
    for i in range(n_stories):
        n_words = n_trs * 3
        tr_times = np.arange(n_trs) * 2.0 + 1.0
        data_times = np.sort(rng.uniform(0, n_trs * 2.0, n_words))
        split = np.clip((data_times // 2.0).astype(int), 0, n_trs - 1)
        rates = np.bincount(split, minlength=n_trs).astype(np.float32)
        delayed = np.stack([np.roll(rates, d) for d in (1, 2, 3, 4)], 1)
        brain = (delayed.astype(np.float32) @ weights
                 + rng.normal(size=(n_trs, n_vox)).astype(np.float32))
        words = [f"w{rng.integers(0, 400)}" for _ in range(n_words)]
        stories.append(StoryData(
            name=f"story{i}", brain_data=brain,
            stimuli=[" ".join(words[max(0, j - 8):j + 1])
                     for j in range(n_words)],
            split_indices=split.tolist(), tr_times=tr_times,
            data_times=data_times, word_rates=rates, words=words,
        ))
    return SimpleNeuroidAssembly(stories, validation_method="outer")


def tiny_gpt2():
    """The JAX example's random-init GPT-2, under torch.manual_seed(0)."""
    import torch
    from transformers import GPT2Config, GPT2Model

    torch.manual_seed(0)
    return GPT2Model(GPT2Config(**TINY_GPT2)).eval()


def make_trainer(device, mesh, model, cache_dir="cache_demo",
                 results_dir="results"):
    """The example's trainer: `model` through the factory's LM extractor on
    `mesh` (None: unsharded), layer 1, on make_assembly()."""
    from litcoder_core_torch import AbstractTrainer, Downsampler, NestedCVModel
    from litcoder_core_torch.features.factory import FeatureExtractorFactory
    from litcoder_core_torch.utils.testing import HashStubTokenizer

    # A tiny random-init GPT-2 stands in for a large checkpoint; with real
    # weights this is `{"model": GPT2Model.from_pretrained("gpt2-xl"),
    # "mesh": mesh}`.
    extractor = FeatureExtractorFactory.create_extractor(
        modality="language_model", model_name="demo-gpt2",
        config={"model": model, "tokenizer": HashStubTokenizer(),
                "mesh": mesh, "layer_idx": 1, "device": device},
        cache_dir=cache_dir,
    )
    return AbstractTrainer(
        assembly=make_assembly(),
        feature_extractors=[extractor],
        downsampler=Downsampler(),
        model=NestedCVModel(seed=0, device=device),
        fir_delays=[1, 2, 3, 4],
        trimming_config={"train_features_start": 3, "train_targets_start": 3,
                         "test_features_start": 2, "test_targets_start": 2},
        use_train_test_split=True,
        layer_idx=1,
        logger_backend="none",
        results_dir=results_dir,
        downsample_config={"method": "lanczos", "window": 3,
                           "cutoff_mult": 1.0},
        # Defaults shown explicitly: the fused downsample+FIR kernel, and
        # device-resident structuring.
        fused_downsample_fir="auto",
        device_resident="auto",
        device=device,
    )


def main(argv=None, device="cuda", mesh=None, model=None):
    """Train on TP-extracted features. `mesh`: a ('data', 'model') Mesh
    from make_lm_mesh (default: every card, two 'data' groups when the
    count is even); `model`: the GPT-2 to shard (default tiny_gpt2()).
    Returns the mesh's shape, the metrics and the best alphas."""
    import torch

    from litcoder_core_torch.parallel.tp import make_lm_mesh
    from litcoder_core_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=device)
    dev = resolve_device(parser.parse_args(argv).device)
    if mesh is None:
        n = (CPU_MESH_ENTRIES if dev.type == "cpu"
             else torch.cuda.device_count())
        n_data = 2 if n % 2 == 0 and n >= 2 else 1
        mesh = make_lm_mesh(n_data, n // n_data, device=dev)
    print(f"extraction mesh: {mesh.shape} on {dev.type}")

    trainer = make_trainer(dev, mesh, tiny_gpt2() if model is None
                           else model)
    metrics = trainer.train(chunk_length=10, n_inner_folds=3)
    print(f"median r = {metrics['median_score']:.3f}, "
          f"significant voxels = {metrics['n_significant']}")
    return {"mesh_shape": mesh.shape, "metrics": metrics,
            "best_alphas": metrics["best_alphas"]}


if __name__ == "__main__":
    main()
