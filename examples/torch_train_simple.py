#!/usr/bin/env python3
"""Minimal LeBel wordrate run from a prepackaged assembly pickle on the
PyTorch port (twin of examples/train_simple.py): the smoke test of a
fresh install.

Usage: python examples/torch_train_simple.py /path/to/assembly_lebel_uts03.pkl

It runs on the card; main(argv, device="cpu") runs on the CPU. main()
returns the metrics it logs.
"""

import logging
import sys

from litcoder_core_torch.assembly.assembly_loader import load_assembly
from litcoder_core_torch.downsample.downsampling import Downsampler
from litcoder_core_torch.features.factory import FeatureExtractorFactory
from litcoder_core_torch.models.nested_cv import NestedCVModel
from litcoder_core_torch.trainer import AbstractTrainer


def main(argv=None, device="cuda"):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
    )
    logger = logging.getLogger(__name__)

    argv = sys.argv[1:] if argv is None else argv
    assembly_path = argv[0] if argv else "assembly_lebel_uts03.pkl"
    logger.info("Loading assembly from %s", assembly_path)
    assembly = load_assembly(assembly_path)

    extractor = FeatureExtractorFactory.create_extractor(
        modality="wordrate", model_name="wordrate", config={},
        cache_dir="cache",
    )
    trainer = AbstractTrainer(
        assembly=assembly,
        feature_extractors=[extractor],
        downsampler=Downsampler(),
        model=NestedCVModel(model_name="ridge_regression", device=device),
        fir_delays=[1, 2, 3, 4],
        # LeBel trimming (reference: train_simple.py:35-40 / unified.py:43-51).
        trimming_config={
            "train_features_start": 10, "train_features_end": -5,
            "train_targets_start": 0, "train_targets_end": None,
            "test_features_start": 50, "test_features_end": -5,
            "test_targets_start": 40, "test_targets_end": None,
        },
        use_train_test_split=True,
        logger_backend="tensorboard",
        dataset_type="lebel",
        results_dir="results",
        downsample_config={},
        device=device,
    )

    logger.info("Starting training (wordrate only)...")
    metrics = trainer.train()
    logger.info("=== Final Results ===")
    logger.info("Median correlation: %.4f", metrics.get("median_score",
                                                         float("nan")))
    if "n_significant" in metrics:
        logger.info("Significant voxels: %s", metrics["n_significant"])
    return metrics


if __name__ == "__main__":
    main()
