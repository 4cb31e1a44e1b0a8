"""Unified CLI of the port (twin of litcoder_core_tpu/cli.py; reference
unified.py:31-555): config-driven end-to-end encoding-model training on
the card.

A thin argparse layer over the per-dataset presets (DATASET_CONFIGS) that
wires the port's components: AssemblyGenerator or load_assembly, the
extractors of FeatureExtractorFactory, Downsampler, NestedCVModel,
BandedRidgeModel or StackedRidgeModel, and AbstractTrainer.

Usage:
    litcoder-torch --dataset_type lebel --assembly_path asm.pkl \\
        --modality wordrate --model_name wordrate \\
        --ndelays 4 --lookback 256 --cache_dir cache [--device cpu]
or `python -m litcoder_core_torch.cli ...`.

The flags are litcoder-tpu's, with the same defaults, choices and errors;
`--device` (cuda, the default, or cpu) is the port's, and run(config)
reads config['device'] ('cuda' when absent). --tp_data x --tp_model > 1
builds one ('data', 'model') extraction mesh per run for the language-model
and speech extractors; --n_devices shards the fit's voxel axis (on the CPU,
n entries of the CPU).
"""

import argparse
import copy
import logging
from datetime import datetime
from typing import Any, Dict, List

from litcoder_core_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# Per-dataset presets (reference: unified.py:35-59).
DATASET_CONFIGS: Dict[str, Dict[str, Any]] = {
    "lpp": {
        "use_train_test_split": False,
        "trimming": {
            "features_start": 5, "features_end": -5,
            "targets_start": 5, "targets_end": -5,
        },
    },
    "lebel": {
        "use_train_test_split": True,
        "trimming": {
            "train_features_start": 10, "train_features_end": -5,
            "train_targets_start": 0, "train_targets_end": None,
            "test_features_start": 50, "test_features_end": -5,
            "test_targets_start": 40, "test_targets_end": None,
        },
    },
    "narratives": {
        "use_train_test_split": False,
        "trimming": {
            "features_start": 14, "features_end": -9,
            "targets_start": 14, "targets_end": -9,
        },
    },
}

TRIMMING_PARAMS = [
    "features_start", "features_end", "targets_start", "targets_end",
    "train_features_start", "train_features_end",
    "train_targets_start", "train_targets_end",
    "test_features_start", "test_features_end",
    "test_targets_start", "test_targets_end",
]


def _build_mesh(config: Dict[str, Any]):
    """Build the ('data', 'model') extraction mesh from --tp_data/--tp_model
    on config['device'] (or return None for single-device extraction).
    Cached on the config dict so every extractor of one run shares a single
    mesh."""
    n_data = config.get("tp_data") or 1
    n_model = config.get("tp_model") or 1
    if n_data * n_model <= 1:
        return None
    if "_mesh" not in config:
        from litcoder_core_torch.parallel.tp import make_lm_mesh

        config["_mesh"] = make_lm_mesh(n_data, n_model,
                                       device=config.get("device", "cuda"))
        logger.info("Feature-extraction mesh: data=%d, model=%d",
                    n_data, n_model)
    return config["_mesh"]


def build_feature_config(modality: str, model_name: str,
                         config: Dict[str, Any]) -> Dict[str, Any]:
    """Per-modality extractor config tables (reference: unified.py:133-158);
    the language-model and speech extractors also get config['device'].

    config['extractor_config_overrides'] ({modality: {key: value}}) merges
    last — the run(config) dict API's hook for injecting model/tokenizer
    instances or extra extractor options; not reachable from argparse."""
    device = config.get("device", "cuda")
    if modality == "language_model":
        out = {
            "model_name": model_name,
            "layer_idx": config["layer_idx"],
            "last_token": config["last_token"],
            "lookback": config["lookback"],
            "dtype": config.get("feature_dtype", "float32"),
            "device": device,
        }
        # Mesh built lazily HERE (not for wordrate/embeddings, which never
        # use it: --tp_* must not fail or silently no-op for those).
        mesh = _build_mesh(config)
        if mesh is not None:
            out["mesh"] = mesh
    elif modality == "speech":
        out = {
            "chunk_size": config.get("chunk_size", 0.1),
            "context_size": config.get("context_size", 16.0),
            "layer": config["layer_idx"],
            "pool": "last",
            "target_sample_rate": 16000,
            "dtype": config.get("feature_dtype", "float32"),
            "device": device,
        }
        mesh = _build_mesh(config)
        if mesh is not None:
            out["mesh"] = mesh
    elif modality == "embeddings":
        out = {
            "vector_path": config.get("vector_path"),
            "binary": config.get("binary", True),
            "lowercase": config.get("lowercase", False),
            "oov_handling": "copy_prev",
        }
    else:
        out = {}
    out.update(
        config.get("extractor_config_overrides", {}).get(modality, {})
    )
    return out


def build_extractors(config: Dict[str, Any]) -> List[Any]:
    from litcoder_core_torch.features.factory import FeatureExtractorFactory

    modalities = config["modalities"]
    model_names = config["model_names"]
    if len(model_names) == 1 and len(modalities) > 1:
        model_names = model_names * len(modalities)
    elif len(model_names) != len(modalities):
        raise ValueError(
            f"Number of model_names ({len(model_names)}) must match "
            f"modalities ({len(modalities)})"
        )
    return [
        FeatureExtractorFactory.create_extractor(
            modality=m, model_name=n,
            config=build_feature_config(m, n, config),
            cache_dir=config["cache_dir"],
        )
        for m, n in zip(modalities, model_names)
    ]


def run(config: Dict[str, Any]) -> Dict[str, Any]:
    """Assemble components from a config dict and train on
    config['device']."""
    from litcoder_core_torch.assembly.assembly_generator import (
        AssemblyGenerator,
    )
    from litcoder_core_torch.assembly.assembly_loader import load_assembly
    from litcoder_core_torch.downsample.downsampling import Downsampler
    from litcoder_core_torch.models.nested_cv import NestedCVModel
    from litcoder_core_torch.trainer import AbstractTrainer

    dataset_config = copy.deepcopy(DATASET_CONFIGS[config["dataset_type"]])
    custom_trimming = {
        p: config[p] for p in TRIMMING_PARAMS if config.get(p) is not None
    }
    if custom_trimming:
        dataset_config["trimming"].update(custom_trimming)
        logger.info("Using custom trimming parameters: %s", custom_trimming)

    if config.get("banded") and config.get("stacking"):
        # Fail fast — before any assembly/data load.
        raise ValueError("--banded and --stacking are mutually exclusive "
                         "(feature-level joint fit vs prediction-level "
                         "blend)")
    # Also before the data load: no card for a CUDA run.
    device = str(resolve_device(config.get("device", "cuda")))

    if config.get("assembly_path"):
        assembly = load_assembly(config["assembly_path"])
    else:
        assembly = AssemblyGenerator.generate_assembly(
            dataset_type=config["dataset_type"],
            data_dir=config["data_dir"],
            subject=config["subject"],
            tr=config["tr"],
            lookback=config["lookback"],
            context_type=config["context_type"],
            use_volume=config["use_volume"],
        )
    logger.info("Assembly loaded with %d stories", len(assembly.stories))

    downsample_config = {
        "method": config["downsample_method"],
        "window": config["lanczos_window"],
        "cutoff_mult": config["lanczos_cutoff_mult"],
    }

    story_selection = None
    if config["dataset_type"] == "lpp" and config.get("story_idx"):
        story_selection = config["story_idx"]  # 1-based single story
    elif config.get("story_order"):
        # Explicit story processing/concatenation order
        # (reference unified.py:308-311).
        story_selection = list(config["story_order"])

    subject_label = config.get("subject") or "prepkg"
    # A caller-provided run_name (e.g. sweeps.expand_grid: one stable name
    # per grid point) overrides the timestamped default.
    run_name = config.get("run_name") or (
        f"{config['dataset_type']}-{subject_label}-"
        f"{datetime.now().strftime('%Y%m%d-%H%M%S')}"
    )
    banded = bool(config.get("banded"))
    stacking = bool(config.get("stacking"))  # exclusivity checked above
    multi_space = banded or stacking
    if multi_space:
        mode = "--banded" if banded else "--stacking"
        # Joint multi-space fitting: one space per modality. Requires the
        # train/test structuring (last story held out).
        if not dataset_config["use_train_test_split"]:
            raise ValueError(
                f"{mode} requires a train/test-split dataset preset "
                "(lebel); LPP/narratives use concatenated full-CV "
                "structuring, which multi-space models do not support"
            )
        # Refuse flags the multi-space models cannot honor rather than
        # dropping them silently (no DataNormalizer hook; per-voxel
        # selection is inherent, so --no_single_alpha is the only — and
        # default — behavior).
        if config.get("normalize_features") or config.get(
                "normalize_targets"):
            raise ValueError(
                "--normalize_features/--normalize_targets are not "
                f"supported with {mode} (no DataNormalizer hook)"
            )
    if banded:
        from litcoder_core_torch.models.banded import BandedRidgeModel

        model = BandedRidgeModel(seed=config.get("seed", 0),
                                 n_gammas=config.get("n_gammas", 10),
                                 n_devices=config.get("n_devices"),
                                 device=device)
    elif stacking:
        if config.get("fast_scan") or \
                config.get("significance", "parametric") != "parametric":
            raise ValueError(
                "--fast_scan/--significance are not supported with "
                "--stacking"
            )
        if config.get("n_permutations", 1000) != 1000 or \
                config.get("n_gammas", 10) != 10:
            # These flags have no effect on the stacked fit; silently
            # accepting them would read as "they took effect".
            raise ValueError(
                "--n_permutations/--n_gammas are not used by --stacking "
                "(permutation significance and gamma scans are banded/"
                "nested-CV options)"
            )
        from litcoder_core_torch.models.stacking import StackedRidgeModel

        model = StackedRidgeModel(seed=config.get("seed", 0),
                                  n_devices=config.get("n_devices"),
                                  device=device)
    else:
        model = NestedCVModel(model_name="ridge_regression",
                              seed=config.get("seed", 0),
                              n_devices=config.get("n_devices"),
                              device=device)
    trainer = AbstractTrainer(
        assembly=assembly,
        feature_extractors=build_extractors(config),
        downsampler=Downsampler(),
        model=model,
        fir_delays=list(range(1, config["ndelays"] + 1)),
        trimming_config=dataset_config["trimming"],
        use_train_test_split=dataset_config["use_train_test_split"],
        layer_idx=config["layer_idx"],
        lookback=config["lookback"],
        dataset_type=config["dataset_type"],
        logger_backend=config["logger_backend"],
        wandb_project_name=config.get("wandb_project_name", "lit-encoding"),
        results_dir=config.get("results_dir", "results"),
        run_name=run_name,
        downsample_config=downsample_config,
        story_selection=story_selection,
        concat_features=not multi_space,
        device=device,
    )
    if stacking:
        train_kwargs = dict(
            folding_type=config["folding_type"],
            n_inner_folds=config["n_inner_folds"],
            chunk_length=config["chunk_length"],
            singcutoff=config["singcutoff"],
            normalpha=True,
            use_corr=True,
            seed=config.get("seed", 0),
        )
    elif banded:
        train_kwargs = dict(
            folding_type=config["folding_type"],
            n_inner_folds=config["n_inner_folds"],
            chunk_length=config["chunk_length"],
            singcutoff=config["singcutoff"],
            normalpha=True,
            use_corr=True,
            seed=config.get("seed", 0),
            fast_scan=config.get("fast_scan", False),
            significance=config.get("significance", "parametric"),
            n_permutations=config.get("n_permutations", 1000),
        )
    else:
        train_kwargs = dict(
            folding_type=config["folding_type"],
            n_outer_folds=config["n_outer_folds"],
            n_inner_folds=config["n_inner_folds"],
            chunk_length=config["chunk_length"],
            singcutoff=config["singcutoff"],
            single_alpha=config.get("single_alpha", True),
            normalpha=True,
            use_corr=True,
            normalize_features=config["normalize_features"],
            normalize_targets=config["normalize_targets"],
            seed=config.get("seed", 0),
            fast_scan=config.get("fast_scan", False),
            significance=config.get("significance", "parametric"),
            n_permutations=config.get("n_permutations", 1000),
        )
    try:
        metrics = trainer.train(**train_kwargs)
    finally:
        closer = getattr(trainer.experiment_logger, "close", None)
        if closer:  # flush/close the event writer (sweeps run many configs)
            closer()
    logger.info("=== Final Results ===")
    logger.info("Median correlation: %.4f", metrics["median_score"])
    if "n_significant" in metrics:
        logger.info("Significant voxels: %s", metrics["n_significant"])
    return metrics


def _fast_scan_arg(s: str):
    """--fast_scan value parser: argparse only converts ValueError-family
    exceptions from type callables into clean usage errors, so raise
    ArgumentTypeError (not KeyError) for anything outside the contract."""
    try:
        return {"true": True, "false": False, "auto": "auto"}[s.lower()]
    except KeyError:
        raise argparse.ArgumentTypeError(
            f"expected 'true', 'false' or 'auto', got {s!r}"
        ) from None


def parse_args(argv=None):
    """CLI surface (reference: unified.py:425-504), litcoder-tpu's flags
    and --device."""
    parser = argparse.ArgumentParser(
        description="Unified trainer for encoding models (PyTorch/CUDA)"
    )
    # Dataset parameters
    parser.add_argument("--dataset_type", type=str, required=True,
                        choices=["lpp", "lebel", "narratives"])
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--assembly_path", type=str, default=None,
                        help="Load a prepackaged assembly pickle instead of "
                             "generating from data_dir")
    parser.add_argument("--subject", type=str, default=None)
    parser.add_argument("--tr", type=float, default=2.0)
    parser.add_argument("--context_type", type=str, default="fullcontext",
                        choices=["fullcontext", "nocontext", "halfcontext"])
    parser.add_argument("--use_volume", action="store_true")
    parser.add_argument("--story_idx", type=int,
                        help="Story index for LPP (1-based)")
    # Modality / model
    parser.add_argument("--modality", type=str)
    parser.add_argument("--modalities", type=str, nargs="+")
    parser.add_argument("--model_name", type=str)
    parser.add_argument("--model_names", type=str, nargs="+")
    parser.add_argument("--layer_idx", type=int, default=9)
    parser.add_argument("--last_token", action="store_true")
    # Training
    parser.add_argument("--n_outer_folds", type=int, default=5)
    parser.add_argument("--n_inner_folds", type=int, default=5)
    parser.add_argument("--folding_type", type=str, default="chunked")
    parser.add_argument("--chunk_length", type=int, default=20)
    parser.add_argument("--singcutoff", type=float, default=1e-10)
    parser.add_argument("--no_single_alpha", dest="single_alpha",
                        action="store_false",
                        help="Per-voxel alphas instead of one global alpha")
    parser.add_argument("--banded", action="store_true",
                        help="Joint banded ridge: one band per modality "
                             "(concat_features=False + BandedRidgeModel); "
                             "requires a train/test-split dataset (lebel)")
    parser.add_argument("--n_gammas", type=int, default=10,
                        help="Banded ridge: number of candidate band-"
                             "variance vectors (row 0 is always uniform)")
    parser.add_argument("--stacking", action="store_true",
                        help="Stacked regression: one ridge model per "
                             "modality, per-voxel simplex blend of their "
                             "predictions (StackedRidgeModel); requires a "
                             "train/test-split dataset (lebel)")
    parser.add_argument("--seed", type=int, default=0)
    # Preprocessing
    parser.add_argument("--downsample_method", type=str, default="lanczos")
    parser.add_argument("--lanczos_cutoff_mult", type=float, default=1.0)
    parser.add_argument("--lanczos_window", type=int, default=3)
    parser.add_argument("--normalize_features", action="store_true")
    parser.add_argument("--normalize_targets", action="store_true")
    parser.add_argument("--ndelays", type=int, required=True)
    parser.add_argument("--lookback", type=int, required=True)
    # System
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="Where every stage runs: the card (default; "
                             "raises without one) or the CPU")
    parser.add_argument("--feature_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="LM/speech forward compute dtype: bfloat16 "
                             "halves weight/activation memory traffic "
                             "(opt-in; features return float32 either way)")
    parser.add_argument("--tp_data", type=int, default=1,
                        help="data-parallel extraction mesh axis (batches "
                             "shard across tp_data devices)")
    parser.add_argument("--tp_model", type=int, default=1,
                        help="tensor-parallel extraction mesh axis "
                             "(LM/speech encoder params shard Megatron-"
                             "style across tp_model devices)")
    parser.add_argument("--use_gpu", action="store_true",
                        help="Accepted for parity; --device picks the "
                             "device")
    parser.add_argument("--fast_scan", nargs="?", const=True, default=False,
                        type=_fast_scan_arg,
                        help="TF32 products for the alpha scan: omit for "
                             "fp32 parity, bare flag or 'true' for always-"
                             "on, 'auto' for the guarded calibration mode")
    parser.add_argument("--significance", type=str, default="parametric",
                        choices=["parametric", "permutation"],
                        help="'permutation' = on-device circular-shift "
                             "nulls (autocorrelation-preserving, one-sided)")
    parser.add_argument("--n_permutations", type=int, default=1000)
    parser.add_argument("--n_devices", type=int, default=None,
                        help="Shard the voxel axis of the ridge solve over "
                             "this many devices (1-D mesh; with --device "
                             "cpu, entries of the CPU). Default: single "
                             "device")
    parser.add_argument("--cache_dir", type=str, required=True)
    parser.add_argument("--results_dir", type=str, default="results")
    # Logging
    parser.add_argument("--logger_backend", type=str, default="tensorboard",
                        choices=["wandb", "tensorboard", "none"])
    parser.add_argument("--wandb_project_name", type=str,
                        default="lit-encoding")
    # Modality-specific
    parser.add_argument("--vector_path", type=str)
    parser.add_argument("--binary", action="store_true")
    parser.add_argument("--lowercase", action="store_true")
    parser.add_argument("--chunk_size", type=float, default=0.1)
    parser.add_argument("--context_size", type=float, default=16.0)
    parser.add_argument("--story_order", type=str, nargs="+")
    # Trimming overrides
    for p in TRIMMING_PARAMS:
        parser.add_argument(f"--{p}", type=int, default=None)
    return parser.parse_args(argv)


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )
    args = parse_args(argv)
    config = vars(args)
    if not config.get("modalities") and not config.get("modality"):
        raise ValueError("Must specify either --modality or --modalities")
    if not config.get("model_names") and not config.get("model_name"):
        raise ValueError("Must specify either --model_name or --model_names")
    if config.get("modality") and not config.get("modalities"):
        config["modalities"] = [config["modality"]]
    if config.get("model_name") and not config.get("model_names"):
        config["model_names"] = [config["model_name"]]
    if not config.get("assembly_path") and not config.get("data_dir"):
        raise ValueError("Must specify either --data_dir or --assembly_path")
    return run(config)


if __name__ == "__main__":
    main()
