#!/usr/bin/env python3
"""LeBel training via AbstractTrainer with command-line arguments, showing
model_kwargs pass-through, on the PyTorch port (twin of
examples/example.py; reference: example.py:22-177).

    python examples/torch_example.py --assembly_path asm.pkl           # card
    python examples/torch_example.py --assembly_path asm.pkl --device cpu

--model_name names a Hugging Face checkpoint (and keys the activation
cache). main() also takes a `model`/`tokenizer` pair, which it passes in
the extractor's config in place of a download, and returns the metrics.
"""

import argparse
import logging

from litcoder_core_torch.assembly.assembly_loader import load_assembly
from litcoder_core_torch.downsample.downsampling import Downsampler
from litcoder_core_torch.features.factory import FeatureExtractorFactory
from litcoder_core_torch.models.nested_cv import NestedCVModel
from litcoder_core_torch.trainer import AbstractTrainer


def parse_args(argv=None, device="cuda"):
    parser = argparse.ArgumentParser(description="LeBel encoding example")
    parser.add_argument("--assembly_path", type=str, required=True)
    parser.add_argument("--modality", type=str, default="language_model")
    parser.add_argument("--model_name", type=str, default="gpt2")
    parser.add_argument("--layer_idx", type=int, default=9)
    parser.add_argument("--lookback", type=int, default=256)
    parser.add_argument("--last_token", action="store_true")
    parser.add_argument("--ndelays", type=int, default=4)
    parser.add_argument("--downsample_method", type=str, default="lanczos")
    parser.add_argument("--cache_dir", type=str, default="cache")
    parser.add_argument("--results_dir", type=str, default="results")
    parser.add_argument("--logger_backend", type=str, default="tensorboard",
                        choices=["wandb", "tensorboard", "none"])
    parser.add_argument("--n_inner_folds", type=int, default=5)
    parser.add_argument("--chunk_length", type=int, default=20)
    parser.add_argument("--single_alpha", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=device,
                        help="torch device of every stage (default: the "
                             "card; 'cpu' for the CPU)")
    return parser.parse_args(argv)


def main(argv=None, device="cuda", model=None, tokenizer=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv, device)
    assembly = load_assembly(args.assembly_path)

    config = {"model_name": args.model_name, "layer_idx": args.layer_idx,
              "last_token": args.last_token, "device": args.device}
    if model is not None:
        config["model"] = model
    if tokenizer is not None:
        config["tokenizer"] = tokenizer
    if args.modality == "wordrate":
        config = {}
    extractor = FeatureExtractorFactory.create_extractor(
        modality=args.modality, model_name=args.model_name, config=config,
        cache_dir=args.cache_dir,
    )
    trainer = AbstractTrainer(
        assembly=assembly,
        feature_extractors=[extractor],
        downsampler=Downsampler(),
        model=NestedCVModel(seed=args.seed, device=args.device),
        fir_delays=list(range(1, args.ndelays + 1)),
        trimming_config={
            "train_features_start": 10, "train_features_end": -5,
            "test_features_start": 50, "test_features_end": -5,
            "test_targets_start": 40,
        },
        use_train_test_split=True,
        layer_idx=args.layer_idx,
        lookback=args.lookback,
        dataset_type="lebel",
        logger_backend=args.logger_backend,
        results_dir=args.results_dir,
        downsample_config=(
            {"method": args.downsample_method, "window": 3,
             "cutoff_mult": 1.0}
            if args.modality != "wordrate" else {}
        ),
        device=args.device,
    )
    # model_kwargs pass through trainer.train() to fit_predict
    # (reference: example.py:104-117).
    metrics = trainer.train(
        n_inner_folds=args.n_inner_folds,
        chunk_length=args.chunk_length,
        single_alpha=args.single_alpha,
        seed=args.seed,
    )
    print(f"Median correlation: {metrics['median_score']:.4f}")
    return metrics


if __name__ == "__main__":
    main()
