#!/usr/bin/env python3
"""Subject x layer sweep farming over the unified pipeline, on the PyTorch
port (twin of examples/sweep_grid.py).

The outermost axis of the framework is embarrassingly parallel job
farming: subjects x models x layers fan out as independent runs. Across
hosts, launch one process per grid slice; within a host this script runs
them one after another on the card with checkpointed RESUME (interrupt it;
rerunning skips completed points).

Usage:
  python examples/torch_sweep_grid.py /path/to/assembly_lebel_uts03.pkl \
      --subjects UTS03 --layers 4 6 8 --out sweep_out [--device cpu]

Each grid point is a full CLI config run (the word rate below; switch
modalities/model_names for LM sweeps: the all-layer activation cache makes
layer sweeps nearly free after the first run). Artifacts per point land in
ModelSaver run dirs named sweep_<label>; the summary table (JSON + CSV)
lands under --out. main() returns the sweep's rows and the table.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from litcoder_core_torch.sweeps import run_grid_sweep, summarize_sweep  # noqa
from litcoder_core_torch.utils.device import resolve_device  # noqa


def main(argv=None, device="cuda"):
    parser = argparse.ArgumentParser()
    parser.add_argument("assembly_path")
    parser.add_argument("--subjects", nargs="+", default=["UTS03"])
    parser.add_argument("--layers", type=int, nargs="+", default=[9])
    parser.add_argument("--out", default="sweep_out")
    parser.add_argument("--device", default=device)
    args = parser.parse_args(argv)
    # The sweep records a failed grid point and goes on, so a missing card
    # must raise here, before the first point.
    resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    base = dict(
        dataset_type="lebel", assembly_path=args.assembly_path,
        data_dir=None, tr=2.0, context_type="fullcontext", use_volume=False,
        story_idx=None, modalities=["wordrate"], model_names=["wordrate"],
        last_token=False, n_outer_folds=5, n_inner_folds=5,
        folding_type="chunked", chunk_length=20, singcutoff=1e-10,
        single_alpha=False, seed=0, downsample_method="lanczos",
        lanczos_cutoff_mult=1.0, lanczos_window=3,
        normalize_features=False, normalize_targets=False,
        ndelays=4, lookback=256,
        cache_dir=os.path.join(args.out, "cache"),
        results_dir=os.path.join(args.out, "results"),
        logger_backend="none",
        # LeBel trimming (reference train_simple.py:35-40).
        train_features_start=10, train_features_end=-5,
        train_targets_start=0, train_targets_end=None,
        test_features_start=50, test_features_end=-5,
        test_targets_start=40, test_targets_end=None,
        device=args.device,
    )
    results = run_grid_sweep(
        base,
        checkpoint_dir=os.path.join(args.out, "ckpt"),
        summary_path=os.path.join(args.out, "summary.json"),
        subject=args.subjects,
        layer_idx=args.layers,
    )
    table = summarize_sweep(results)
    print(table)
    return results, table


if __name__ == "__main__":
    main()
