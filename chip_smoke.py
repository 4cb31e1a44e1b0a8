#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (litcoder_core_torch) on one NVIDIA card.

Run from the repository root: python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:
  1. device: a CUDA card is required; its name and power limit as nvidia-smi
     reports them.
  2. build: nvcc builds csrc/lanczos_fir.cu from the checkout; the
     versions of the optional packages (transformers, tensorboard,
     matplotlib, seaborn) or that they are absent, and whether pandas,
     scipy, soundfile, nibabel and nilearn are installed (read without
     importing them).
  3. kernel: the fused Lanczos+FIR CUDA kernel against its plain torch
     version on the card (atol 1e-4, the bar the TPU kernel met against the
     two-stage path), at the trainer's main shape, at the main shape with
     word times permuted, with a 60 s silent gap and with descending TR
     times, at the shapes of tests/test_pallas_kernels.py, at one shape
     of two scan passes, at the Narratives 21styear shape (8,434 words,
     2,249 TRs, D=768, delays 1-8) and at the speech shape (3,441 frames at
     16.0 + 0.1 i s onto 240 TRs of 1.5 s, D=768, delays 1-8, whose first
     TR tile no frame reaches: those rows must be exact zeros); the word
     tiles each launch visits beside the dense count. Times at the main,
     the Narratives and the speech shapes: the
     kernel and torch.matmul(K_all, data) each as back-to-back launches
     between one pair of CUDA events, rotating over operand sets that
     together exceed the 50 MB L2 (so each launch finds its operands cold),
     and as single calls.
  4. small parity: the port's AbstractTrainer on small synthetic
     assemblies, on the card and on the CPU, in train/test mode and in
     concatenated full nested-CV mode on both routes (tall chunked folds:
     fused; wide kfold_trimmed folds: per-fold with the dual search); then
     fit_nested_cv on small seeded problems through every other search
     path: method='eigh' (complement-gram eigh) and 'svd' (spectral),
     normalpha=False on a wide design (spectral dual), unequal folds (the
     per-fold loop), voxel chunks in both modes, fast_scan True and 'auto',
     and permutation significance (the offsets come from a CPU generator,
     so both devices use the same ones and their p-values must be equal).
     Same alphas, correlations within 2e-3, median r within 1e-3, the same
     solver_paths. Then the fused step parallel.nested_cv_step on a seeded
     problem (T=410, D=12, V=40, 4 equal folds of 10-row chunks) with
     method 'auto' (Woodbury scan, union refit), 'chol', 'eigh', 'svd' on
     non-complementary folds, single_alpha=True and use_corr=False: the
     scan and refit each run took (the step's log line), the same alphas
     and correlations within 1e-5 on card and CPU. Then the ten Downsampler
     methods on one small story, card against CPU within 1e-5 of the CPU's
     largest magnitude. Then the language-model extractor: a tiny GPT-2
     (2 layers, width 16; a stand-in decoder of that shape without
     transformers) over HashStubTokenizer fullcontext windows of three
     small stories, every layer card against CPU within 1e-5 of the CPU's
     largest magnitude, and the port's trainer on those stories (responses
     carrying a signal of the CPU's layer-1 features) on both, with the
     same alphas and the parity bars above. Then the speech extractor: a
     tiny Wav2Vec2 (2 layers of width 24) in both feature-encoder norm
     variants ('layer' with stable layer norm, and 'group') and both pools
     over 180 s of audio, every layer card against CPU within 1e-5 of the
     CPU's largest magnitude, and phase 13's Narratives trainer on that
     tiny data dir (120 TRs, 40 voxels) on both, with the same alphas and
     the parity bars above. Then fit_banded_ridge on small seeded problems
     (T=240, bands of 24 and 16, V=23 or 80; a wide one; a square one with
     T_tr = D for method='dual') through every scan route: chol on both
     sides of its solve association, chunked chol with a tail chunk on a
     response on the device, host-streamed, dual, forced dual, eigh,
     svd_fallback, fast_scan True and 'auto', and permutation significance
     (equal p-values); fit_stacked_ridge on its grouped-Cholesky and
     spectral refits and its chunked route; variance_partitioning with 2
     spaces. The same alphas, gammas and solver_paths, correlations within
     1e-5, stack weights within 1e-4, variance components within 1e-4.
     Then the command line: cli.run on a small LeBel pickle (4 stories of
     120 TRs, V=40) with the word rate, then the word rate and 6-wide
     embeddings --banded and --stacking, and LinearPredictivityModel on a
     seeded (400, 12) problem in 4 groups, card against CPU: the same
     alphas, gammas and solver_paths, correlations within 1e-5, mean stack
     weights within 1e-4, each fold's coefficients within 1e-5 of the
     CPU's largest.
  5. main path: AbstractTrainer(...).train() on the card at full width, a
     LeBel-UTS03-shaped synthetic assembly (85 stories of 320 TRs, 768-wide
     static embeddings, FIR delays 1-4, V=20484 fsaverage5 vertices,
     10 alphas, 5 inner folds, chunks of 20 TRs).
  6. Narratives path: AbstractTrainer(use_train_test_split=False).train()
     on the card at full width: one 21styear-shaped story (2,249 TRs at
     1.5 s, 768-wide static embeddings, FIR delays 1-8 so D=6144,
     V=20484), trimmed 14:-9, fitted as README section 3 does
     (kfold_trimmed, 5 outer x 5 inner folds, single alpha): full nested-CV
     mode, per-fold route, dual search.
  7. fused full-CV route at full size: NestedCVModel(device="cuda")
     .fit_predict(X, Y) on the benchmarks/full_cv.py problem (T=26880,
     D=3072, V=20484, rank-256 signal plus unit noise, chunked 5 x 5 folds
     of 20-row chunks, 10 alphas, return_weights=False), built on the card
     from a seed; then the same fit with voxel_chunk_size=4096 (chunked
     downdate, inner scoring and refit), which must select the same alphas
     on at least 99.9% of the voxels.
  8. the north-star whole-brain fit (benchmarks/northstar.py, uncut):
     T=26880 train and 2048 test rows, D=3072, V=95556, the phase 7
     generator, NestedCVModel(device="cuda").fit_predict in train/test mode
     three times: (a) voxel_chunk_size=4096, (b) no voxel chunks, (c) 4096
     with fast_scan='auto' and 1,000-shift permutation significance; the
     first 64 voxels carry no signal. (a) and (b) must pick the same alpha
     on at least 99.9% of the voxels with correlations within 1e-4 where
     they do; (c) must record its guard's decision, agree with (a) on at
     least 98% of the voxels when it accepted (correlations within 1e-4
     where the alphas agree), floor its p-values at 1/1001 and keep the
     median r within 1e-3 of (a)'s. (c)'s p-values of the first 256 voxels
     must equal a plain float64 torch.roll null on the same predictions and
     offsets, and the noise-only voxels must not sit at the floor.
  9. the eigh search at full width: the phase 8 generator at the surface
     width V=20484, method='auto' (the Cholesky search) against
     method='eigh', with chunks of 20 rows (unequal folds: the per-fold
     loop) and of 21 (equal partition folds: complement-gram eigh): the
     same alpha on at least 99.9% of the voxels, correlations within 2e-3,
     median r within 1e-3.
 10. the fused step at full size: (a) bench.py's problem (T=4096, TP=512,
     D=1536, V=20484, 10 alphas, equal_size_folds(4096, 5, 20): Tva=800,
     a 4,000-row union, k=96) drawn on the card, nested_cv_step with
     method 'auto' (Woodbury), 'chol', 'eigh' and 'auto' with
     fast_scan=True, each one warm run then the median of 3 synchronized
     walls and the peak memory; the fp32 three pick the same alpha on at
     least 99.9% of the voxels; the fast scan's agreement; bench.py's stage
     split (scan, scan at A=1, refit, predict+score, alpha grid and
     fold-fixed) and achieved TFLOP/s from bench.py's FLOP count. (b) the
     phase 9 generator at T=26880 (+2048 test rows), D=3072, V=20484 with
     equal_size_folds(26880, 5, 20) (Tva=5360, k=80): 'auto' against
     'chol', the same alpha on at least 99.9% of the voxels.
 11. the other downsamplers at full size: (a) all ten methods on story 0
     of the phase 5 assembly (about 1,600 words x 768 features, 320 TRs;
     gabor with freqs 0.1, 0.2, 0.3 Hz and sigma 2 s), card against CPU
     within 1e-4 of the CPU's largest magnitude, with ms per call; (b)
     the phase 5 trainer with downsample_config={'method': 'average'} (the
     two-stage path with per-word TR ids): stage split, median r above
     AVERAGE_MEDIAN_R_FLOOR, finite metrics, the Cholesky search.
 12. language-model trainer at full width: a GPT-2-small-shaped model
     (GPT2Model(GPT2Config()) when transformers imports, else a stand-in
     decoder of the same shape defined here; random init under
     torch.manual_seed(0)) through the port's LM extractor and trainer on
     the card, on the first 12 stories of the phase 5 assembly with their
     stimuli replaced by fullcontext windows of 256 words over
     HashStubTokenizer (about 1,600 windows a story: one prefix chain of
     256, the rest full windows of 257 tokens), layer 9, last-token
     pooling, batches of 64, the fused Lanczos+FIR stage, LeBel trimming.
     Checks: (a) story 0's first 64 windows and 8 full windows from its
     middle, card against CPU within 1e-3 of the CPU's largest magnitude on
     every layer; (b) the same windows with prefix sharing on and off on
     the card within 1e-4; (c) 12 kernel launches in the first train();
     (d) finite metrics and the JAX fit's solver_paths (the dual search);
     (e) a second train() on the same cache directory runs no forward and
     gives the same metrics. Prints windows, real and padded tokens,
     forwards, windows/s and tokens/s, the extractor's summed stage
     seconds, both runs' stage split, peak memory and median r.
 13. README section 3 with speech features at full width: a Narratives
     data dir written from a seed (one 21styear story of 240 TRs of 1.5 s,
     words at about 2.5 words/s, 360 s of 16 kHz audio, an empty
     placeholder with the BOLD NIfTI's name) and the surface cache seeded
     with its (240, 20484) responses, a planted signal of the delayed word
     rate plus noise, so AssemblyGenerator.generate_assembly('narratives',
     ...) takes the processor's cache-hit path and needs no nibabel; then
     the factory's speech extractor on Wav2Vec2Model(Wav2Vec2Config())
     (wav2vec2-base's width and depth, random init under
     torch.manual_seed(0)) with cli.py's windows of 16 s every 0.1 s
     (3,441 windows), layer 9, last-frame pooling, beside the wordrate
     extractor, into AbstractTrainer(use_train_test_split=False) with
     delays 1-8 (D = 8 x 768 + 8), trims 14:-9 and section 3's fit.
     Checks: (a) the first 4 windows card against CPU within 1e-3 of the
     CPU's largest magnitude on every layer; (b) 1 kernel launch in
     train(); (c) finite metrics and the JAX fit's solver_paths (per-fold,
     dual search); (d) a second train() on the same cache directory runs
     no forward and gives the same metrics bit for bit. Prints windows,
     windows/s, audio seconds per wall second, the host preprocessing of
     64 windows timed alone, both runs' stage split, peak memory and
     median r.
 14. README section 4's --banded fit at full width, on phase 5's assembly
     with the word rate and the embeddings as two feature spaces
     (AbstractTrainer(concat_features=False), delays 1-4, D = 4 + 3,072,
     LeBel trims, 10 alphas, 5 inner folds of 20-row chunks): (a)
     BandedRidgeModel(n_gammas=10): 85 kernel launches, finite metrics,
     best_gammas of shape (V, 2), the JAX fit's routes (chol scan,
     grouped_chol refit), median r above MEDIAN_R_FLOOR; (b)
     StackedRidgeModel: 85 launches, stack weights on the simplex (non-
     negative, rows summing to 1 within 1e-5), the blend's median r beside
     each space's; (c) variance_partitioning of (a)'s structured spaces:
     finite, r2_AB - unique_A - unique_B - shared within 1e-6 of 0; (d)
     fit_banded_ridge at benchmarks/banded_scan.py's surface problem,
     uncut (T=26,880, bands 3,072 + 2,048 + 4, V=20,484, 2,048 test rows,
     drawn on the card), 5 gammas, once with Y on the card and once with Y
     as host numpy streamed in voxel chunks of 8,192: the same (gamma,
     alpha) on at least 99.9% of the voxels, correlations within 1e-4
     where they agree. Each fit prints its wall, stage split, peak memory,
     median r and route.
 15. README section 4's command line at full width: (a) phase 5's assembly
     saved as a pickle (85 stories x 305 rows x 20,484 vertices, held
     twice by the assembly: about 4.3 GB; write and load timed) and
     cli.main(argv) with the argv a user would type (--dataset_type lebel
     --assembly_path ... --modality embeddings --model_name random-static
     --vector_path <phase 5's .kv> --ndelays 4 --lookback 256 --cache_dir
     ... --results_dir ... --logger_backend none; the device defaults to
     the card): 85 kernel
     launches, the same alphas, median r within 1e-6 and solver_paths as
     phase 5's trainer fitted with the CLI's train() arguments (one alpha
     for all voxels: cli.py's default), median r above MEDIAN_R_FLOOR;
     (b) --modalities wordrate embeddings with --banded, then --stacking:
     their defaults are phase 14 (a)-(b)'s arguments, so 85 launches each
     and phase 14's alphas (and gammas) and median r within 1e-6; (c)
     sweeps.run_grid_sweep over layers 3, 6, 9 and 11 of phase 12's 12
     stories saved as a pickle, the GPT-2-small-shaped model and
     HashStubTokenizer injected through extractor_config_overrides and the
     cache keys of phase 12 (model name, lookback 256, fullcontext, last
     token, lebel): no window extracted, 48 launches, then a second call
     that resumes from its checkpoints (no cli.run, no new run directory,
     the same rows); (d) LinearPredictivityModel.fit at T=26,880, D=3,072,
     V=20,484 (phase 9's generator) in 5 GroupKFold folds of groups of 320
     rows: seconds per fold's SVD solve, fold 1's coefficients of 256
     voxels within 1e-4 of a float64 solve on the card (relative to its
     largest), median r above FUSED_MEDIAN_R_FLOOR. Each run prints its
     wall, stage split, peak memory and the card.
 16. the mesh paths (parallel/mesh.py, parallel/tp.py) on meshes that
     repeat cuda:0: (a) phase 8 (b)'s north-star fit on 8 entries (V % 8
     = 4: the pad runs) against phase 8 (b) (the same alpha on 99.9% of
     the voxels, median r within 1e-5, its solver_paths), with n_devices=1
     (every alpha, correlations within 1e-6), and make_mesh(2) refused on
     one card; (b) phase 14 (a)-(b)'s trainers with the banded and stacked
     models on 4 entries (85 launches each, 99.9% of phase 14's picks,
     median r within 1e-4, the spectral and per-voxel-index Cholesky
     refits); (c) phase 10's 'auto' step on 4 entries (99.9% of the
     alphas, correlations within 1e-5, shards of V/4); (d) phase 12's model
     on a (2, 2) mesh over two of its stories and phase 13's encoder on
     (1, 2) over 30 s of its audio, every layer within 1e-4 of its largest
     magnitude against the unsharded extractor, windows/s beside the
     unsharded rate, and phase 12's trainer on those TP features (its
     other stories from phase 12's cache): 12 launches, phase 12's alphas
     on 99.9% of the voxels; (e) phase 15 (a)'s argv with --n_devices 1
     (85 launches, its alphas and median r exactly), and --tp_data 1
     --tp_model 2 refused by make_lm_mesh on one card.
Phases 5, 6, 12, 13, 14 (a)-(b), 15 (a)-(c) and 16's trainers set the
kernel's launch count to 0 just before they run and read it just after; phases 7-10 call
the fit or the step directly and print each fit's wall, median r, route
and peak device memory. The last two lines are a JSON record of the kernel
(launches on the main path, on the Narratives, LM, speech, banded,
command-line and mesh paths; times at the Narratives and the speech
shapes) and
{"ok": true, "device": {...}}.

Imports nothing of JAX or of litcoder_core_tpu.
"""

import contextlib
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

MAIN_SHAPE = dict(t_w=1600, t_tr=320, dim=768, delays=(1, 2, 3, 4))
# (t_w, dim, t_tr, delays, word-time span): the shapes of
# tests/test_pallas_kernels.py, ragged feature tiles and the shape the TPU
# dispatch sent to XLA included.
TEST_SHAPES = [
    (230, 17, 49, (1, 2, 3, 4), 100.0),
    (230, 5, 49, (0,), 100.0),
    (230, 5, 49, (-2, 0, 3), 100.0),
    (230, 300, 49, (1, 2), 100.0),
    (90, 7, 25, (0, 1, 2, -1), 60.0),
    (4600, 3, 512, (1, 2), 1000.0),
]
# Shapes for the kernel's other paths: float4 columns over two scan passes
# (more than 4096 words) with a negative delay.
PATH_SHAPES = [
    (4600, 64, 512, (1, 2, -3), 1000.0),
]
KERNEL_ATOL = 1e-4
GAP_SECONDS = 60.0

# The Narratives 21styear story (cli.py's narratives preset, README section
# 3): 2,249 TRs of 1.5 s, about 2.5 words/s, GPT-2-small width, 8 delays.
NARR_TR, NARR_TR_SECONDS, NARR_DELAYS = 2249, 1.5, tuple(range(1, 9))
NARR_WORDS = int(NARR_TR * NARR_TR_SECONDS * 2.5)

# The speech extractor's frames over phase 13's 360 s of audio (cli.py's
# speech defaults: a 16 s context at 0.1 s strides): 3,441 frame times
# 16.0 + 0.1 i at wav2vec2-base's width, onto 240 TRs of 1.5 s from 0 s,
# 8 delays. TRs more than the Lanczos reach (3 lobes of 1.5 s) before the
# first frame get no frame: the first TR tile's rows must come out as
# exact zeros.
SPEECH_FRAMES, SPEECH_FIRST_FRAME, SPEECH_STRIDE = 3441, 16.0, 0.1
SPEECH_TR, SPEECH_TR_SECONDS = 240, 1.5

# Back-to-back timing: distinct operand sets (TIMING_SETS at the main shape,
# NARR_TIMING_SETS at the Narratives shape, where each set alone exceeds the
# L2, SPEECH_TIMING_SETS of 16.5 MB at the speech shape), each launched
# TIMING_ROUNDS times per timed run. A spin kernel of
# HOLD_CYCLES clock cycles holds the stream while the host enqueues, so the
# host's launch overhead does not enter the device time. A run in which the
# host outran the hold (a busy shared host) is run again with the hold
# doubled, up to MAX_HOLD_DOUBLINGS times, and is never kept.
TIMING_SETS = 12
NARR_TIMING_SETS = 3
SPEECH_TIMING_SETS = 6
TIMING_ROUNDS = 10
HOLD_CYCLES = 20_000_000
MAX_HOLD_DOUBLINGS = 4

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bandwidth and
# float32 outside the tensor cores (the kernel's FMAs).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# Full-size configuration (LeBel UTS03 shape, GPT-2-small width).
N_STORIES, N_TR, TR_SECONDS, WORDS_PER_S = 85, 320, 2.0, 2.5
EMB_DIM, N_VERTICES, VOCAB = 768, 20484, 10000
SIGNAL_RANK = 16
NOISE_STD = 2.0
# LeBel trimming (examples/train_simple.py): brain data holds n_TR - 15
# rows, row i answering TR i + 10.
LEBEL_TRIM = {
    "train_features_start": 10, "train_features_end": -5,
    "train_targets_start": 0, "train_targets_end": None,
    "test_features_start": 50, "test_features_end": -5,
    "test_targets_start": 40, "test_targets_end": None,
}
# The planted signal caps a voxel's r near std(s)/sqrt(var(s) + var(noise))
# (printed as `ceiling`); chance level for the 265 held-out
# rows is about +-0.06 per voxel. A median r above 0.2 shows the fit found
# the signal without asking it to reach the ceiling.
MEDIAN_R_FLOOR = 0.2

# Narratives trimming (cli.py's narratives preset) and README section 3's
# fit: the concatenated story fits in full nested-CV mode.
NARR_TRIM = {"features_start": 14, "features_end": -9,
             "targets_start": 14, "targets_end": -9}
NARR_FIT = dict(folding_type="kfold_trimmed", n_outer_folds=5,
                n_inner_folds=5, chunk_length=20, single_alpha=True, seed=0)
NARR_NOISE_STD = 1.0
# Each outer fold's held-out block is about 435 rows (chance about +-0.1
# per voxel); with D = 6144 features over about 1,780 training rows ridge
# recovers only part of the planted signal, so the floor sits well under the
# printed ceiling while far above chance.
NARR_MEDIAN_R_FLOOR = 0.25

# The fused full-CV problem of benchmarks/full_cv.py: X (T, D) normal,
# Y = X W M + unit noise with W (D, 256) / sqrt(D) and M (256, V) / 16, so
# each voxel's signal variance is about 1 and its r ceiling about 0.707.
FUSED_T, FUSED_D, FUSED_RANK, FUSED_CHUNK = 26880, 3072, 256, 20
FUSED_MEDIAN_R_FLOOR = 0.5

EXPECTED_PATHS = {"mode": "train_test", "alpha_search": "chol",
                  "fast_scan": "off"}
FUSED_PATHS = {"mode": "full_cv_fused", "alpha_search": "fused_chol",
               "fast_scan": "off"}
PER_FOLD_DUAL_PATHS = {"mode": "full_cv_per_fold", "alpha_search": "dual",
                       "fast_scan": "off"}
FULL_CV_KEYS = {"majority_significant_mask", "n_majority_significant",
                "percent_majority_significant", "corrected_p_values",
                "significant_mask", "n_significant"}

# Phase 4's solver cases: seeded problems of 400 train and 100 test rows,
# D=12 (tall) or 200 rows and D=240 (wide), V=40, chunks of 20 rows in 5
# inner folds; (label, problem, fit arguments, expected solver_paths).
SMALL_FIT = dict(chunk_length=20, n_inner_folds=5, seed=0)


def _paths(search, fast_scan="off", mode="train_test"):
    return {"mode": mode, "alpha_search": search, "fast_scan": fast_scan}


SOLVER_CASES = [
    ("method='eigh'", "tall", dict(method="eigh"), _paths("complement_eigh")),
    ("method='svd'", "tall", dict(method="svd"), _paths("spectral_svd")),
    ("normalpha=False, wide", "wide", dict(normalpha=False),
     _paths("spectral_dual")),
    ("unequal folds", "tall", dict(normalpha=False, chunk_length=7),
     _paths("per_fold_loop_auto")),
    ("voxel chunks", "tall", dict(voxel_chunk_size=7), _paths("chol")),
    ("voxel chunks, eigh", "tall", dict(method="eigh", voxel_chunk_size=7),
     _paths("complement_eigh")),
    ("full CV, voxel chunks", "full",
     dict(voxel_chunk_size=7, n_outer_folds=3, n_inner_folds=3),
     _paths("fused_chol", mode="full_cv_fused")),
    ("fast_scan=True", "tall", dict(fast_scan=True), _paths("chol", "bf16")),
    ("fast_scan='auto'", "tall", dict(fast_scan="auto"),
     _paths("chol", "auto_accepted")),
    ("permutation", "tall",
     dict(significance="permutation", n_permutations=500,
          voxel_chunk_size=7), _paths("chol")),
]

# Phases 8-9: benchmarks/northstar.py's LeBel-UTS03 / GPT-2-small problem
# (26,880 train and 2,048 test TRs, D = 768 x 4 delays) with the phase 7
# generator, at whole-brain V = 95,556 and at the fsaverage5 surface.
NS_T, NS_TEST, NS_D, NS_V = 26880, 2048, 3072, 95556
NS_CHUNK, NS_PERMUTATIONS = 4096, 1000
# Phase 8 zeroes the signal of its first NS_NULL voxels (pure noise: their
# permutation p-values must spread over (0, 1]) and holds (c)'s p-values of
# its first NS_ROLL_BLOCK voxels, those included, against a plain roll null.
NS_NULL, NS_ROLL_BLOCK = 64, 256

# Phase 4's step cases: (label, folds, nested_cv_step arguments, the route
# the step must log). 'equal' folds are equal_size_folds(STEP_T, 4, 10):
# 400 rows in the union, so the union refit corrects for k=10 rows;
# 'noncomp' adds those 10 rows to every train block.
STEP_T, STEP_FOLDS, STEP_CHUNK = 410, 4, 10
UNION_ROUTE = "woodbury scan, union_woodbury refit"
STEP_CASES = [
    ("method='auto'", "equal", {}, UNION_ROUTE),
    ("method='chol'", "equal", dict(method="chol"), "chol scan, full refit"),
    ("method='eigh'", "equal", dict(method="eigh"), "eigh scan, full refit"),
    ("method='svd', non-complementary folds", "noncomp", dict(method="svd"),
     "per_fold scan, full refit"),
    ("single_alpha=True", "equal", dict(single_alpha=True), UNION_ROUTE),
    ("use_corr=False", "equal", dict(use_corr=False), UNION_ROUTE),
]
STEP_ATOL = 1e-5

# Phase 10 (a): bench.py's problem (bench.py:42) and its fold scheme.
BENCH_T, BENCH_TP, BENCH_D, BENCH_A, BENCH_F, BENCH_CHUNK = (
    4096, 512, 1536, 10, 5, 20)
# Y = X W + unit noise with W (D, V) / sqrt(D): the signal's variance is
# about 1, so r's ceiling is about 0.707; ridge from 3,200 training rows
# of 1,536 features recovers well under it, far above chance (about
# +-0.09 per voxel for the 512 held-out rows).
BENCH_MEDIAN_R_FLOOR = 0.3

# Phases 4 and 11: the Downsampler methods and their arguments; the
# split-index methods take per-word TR ids (average, sum, last) or np.split
# boundaries (legacy_*).
DOWNSAMPLE_KWARGS = {
    "rect": {},
    "lanczos": {"window": 3, "cutoff_mult": 1.0},
    "sinc": {"window": 3, "cutoff_mult": 1.0},
    "gabor": {"freqs": [0.1, 0.2, 0.3], "sigma": 2.0},
    "average": {}, "sum": {}, "last": {},
    "legacy_average": {}, "legacy_sum": {}, "legacy_last": {},
}
# Phase 11 (b): the planted signal is built from Lanczos-downsampled
# features, which the per-TR word average only approximates (a box of one
# TR with each word weighted 1 / count, against a 3-lobe kernel over
# neighbouring TRs), so it recovers less of the signal than phase 5 does;
# the floor stays far above chance.
AVERAGE_MEDIAN_R_FLOOR = 0.35

# Phase 4's banded, stacking and variance-partitioning cases: the problems
# of tests/test_torch_banded*.py, test_torch_stacking.py and
# test_torch_variance_partition.py. Banded: T=240 rows in 4 chunked folds of
# 10-row chunks (Tva=60), 40 test rows, bands of 24 and 16 with V=23 (the
# scan solves against s X^T Y) or V=80 (against Xva^T); 'wide' has bands of
# 100 and 80 on 120 rows (the dual scan); 'square' bands of 100 and 80 on
# 240 rows, T_tr = D = 180 (method='dual' on a tall design, whose kernels
# are full-rank only there: ROADMAP.md C). Card against CPU: the same
# alphas, gammas and solver_paths, correlations within 1e-5; stack weights
# within 1e-4 (1,500 FISTA steps on A and b that differ in the last
# bits); variance components, sums of up to three signed squares of such
# correlations, within 1e-4.
BANDED_FIT = dict(alphas=np.logspace(-1, 5, 6), n_gammas=4, n_inner_folds=4,
                  chunk_length=10, seed=0)
BANDED_ATOL, STACK_W_ATOL, VP_ATOL = 1e-5, 1e-4, 1e-4


def _banded_paths(scan, refit):
    return {"banded_scan": scan, "banded_refit": refit}


CHOL_BANDED = _banded_paths("chol", "grouped_chol")
BANDED_CASES = [
    # (label, problem, response on the device, fit arguments, solver_paths)
    ("chol, V < Tva", "tall", True, {}, CHOL_BANDED),
    ("chol, V >= Tva", "tall80", True, {}, CHOL_BANDED),
    ("chunked chol, chunks of 7 (a tail of 2)", "tall", True,
     dict(voxel_chunk_size=7), CHOL_BANDED),
    ("host-streamed, chunks of 7", "tall", False, dict(voxel_chunk_size=7),
     CHOL_BANDED),
    ("dual, wide", "wide", True, {}, _banded_paths("dual", "spectral")),
    ("method='dual', T_tr = D", "square", True, dict(method="dual"),
     _banded_paths("dual", "spectral")),
    ("method='eigh'", "tall", True, dict(method="eigh"),
     _banded_paths("eigh", "spectral")),
    ("method='svd'", "tall", True, dict(method="svd"),
     _banded_paths("svd_fallback", "spectral")),
    ("fast_scan=True", "tall", True, dict(fast_scan=True), CHOL_BANDED),
    ("fast_scan='auto'", "tall", True, dict(fast_scan="auto"), CHOL_BANDED),
    ("permutation", "tall", True,
     dict(significance="permutation", n_permutations=500), CHOL_BANDED),
]
STACK_FIT = dict(alphas=np.logspace(-1, 4, 6), n_inner_folds=3,
                 chunk_length=10, seed=0)
STACK_CASES = [
    # (label, fit arguments, oof_refit)
    ("grouped Cholesky", {}, "grouped_chol"),
    ("spectral", dict(method="eigh"), "spectral"),
    ("chunked, chunks of 7", dict(voxel_chunk_size=7),
     "grouped_chol_chunked"),
]

# Phase 14: README section 4's --banded fit on phase 5's assembly (word
# rate and 768-wide embeddings as two spaces, D = 4 + 3,072), 10 gammas,
# 10 alphas, 5 inner folds of 20-row chunks. The planted signal and its
# ceiling are phase 5's, so MEDIAN_R_FLOOR and its reason hold.
BANDED_N_GAMMAS = 10
STACKED_PATHS = {"fast_scan": "off", "alpha_search": "chol",
                 "oof_refit": "grouped_chol_chunked"}
STACK_SIMPLEX_ATOL, VP_IDENTITY_ATOL = 1e-5, 1e-6
# Phase 14 (d): benchmarks/banded_scan.py's surface problem, uncut: bands of
# 3,072 (GPT-2 768 x 4 delays), 2,048 and 4 columns, T=26,880 training and
# 2,048 test rows, V=20,484, Y = (sum_b X_b W_b) M + unit noise with W_b
# (D_b, 128) / sqrt(D_b) and M (128, V) / 12, 10 alphas, 5 inner folds of
# 20-row chunks, return_weights=False; 5 gammas. Each voxel's signal
# variance is about 3 x 128 / 144 = 2.7, its r ceiling about 0.85; ridge
# from 21,504 training rows of 5,124 features recovers most of it, so the
# floor sits well under the ceiling and far above chance (about +-0.04 per
# voxel for 2,048 test rows). The device-resident fit and the host-streamed
# one (voxel chunks of 8,192) must pick the same (gamma, alpha) on at least
# 99.9% of the voxels, with correlations within 1e-4 where they do.
BSCAN_T, BSCAN_TP, BSCAN_BANDS, BSCAN_RANK = 26880, 2048, (3072, 2048, 4), 128
BSCAN_GAMMAS, BSCAN_CHUNK, BSCAN_MEDIAN_R_FLOOR = 5, 8192, 0.5

# Phase 4's command-line cases: cli.run on a small LeBel pickle (4 stories
# of 120 TRs, 6-wide embeddings, V=40) with the word rate, then the word
# rate and the embeddings --banded (4 gammas) and --stacking, 3 inner folds
# of 10-row chunks; and LinearPredictivityModel on a seeded (400, 12)
# problem, V=40, 4 groups of 100 rows, 4 folds. Card against CPU: the same
# alphas, gammas and solver_paths, correlations within 1e-5 (BANDED_ATOL),
# stack weights within 1e-4, least-squares coefficients within 1e-5 of the
# CPU's largest.
SMALL_CLI_CASES = [
    ("wordrate", ["--modalities", "wordrate", "--model_names", "wordrate"]),
    ("--banded", ["--modalities", "wordrate", "embeddings", "--model_names",
                  "wordrate", "random-static", "--banded", "--n_gammas",
                  "4"]),
    ("--stacking", ["--modalities", "wordrate", "embeddings",
                    "--model_names", "wordrate", "random-static",
                    "--stacking"]),
]
SMALL_LINEAR_T, SMALL_LINEAR_D, SMALL_LINEAR_GROUPS = 400, 12, 4
LINEAR_COEF_RTOL = 1e-5

# Phase 15: README section 4's command line at full width. (a) cli.main on
# phase 5's assembly saved as a pickle, beside phase 5's trainer fitted with
# the CLI's train() arguments (cli.py's defaults: one alpha for all voxels,
# chunked folds of 20 rows, 5 inner folds); (b) --banded and --stacking
# with the word rate and the embeddings, whose defaults (10 gammas, 5 inner
# folds, chunks of 20) are phase 14 (a)-(b)'s arguments, so they must give
# phase 14's picks and median r; (c) a layer sweep over phase 12's
# activation cache (GPT-2 small has 12 blocks, layers 0-11: the sweep
# takes 3, 6, 9 and 11), run twice (the second resumes from its
# checkpoints); (d) LinearPredictivityModel at phase 9's generator's full
# width (T=26,880, D=3,072, V=20,484) in 5 GroupKFold folds of groups of
# 320 rows, the first fold's coefficients of LINEAR_CHECK_VOXELS voxels
# against a float64 solve on the card (within 1e-4 of its largest), median
# r above FUSED_MEDIAN_R_FLOOR (ordinary least squares from 21,504 rows of
# 3,072 features keeps most of the 0.707 ceiling).
CLI_TRAIN = dict(folding_type="chunked", n_outer_folds=5, n_inner_folds=5,
                 chunk_length=20, singcutoff=1e-10, single_alpha=True,
                 normalpha=True, use_corr=True, normalize_features=False,
                 normalize_targets=False, seed=0, fast_scan=False,
                 significance="parametric", n_permutations=1000)
CLI_SAME_R_ATOL = 1e-6
CLI_LAYERS = [3, 6, 9, 11]
LINEAR_T, LINEAR_GROUP_ROWS, LINEAR_FOLDS = 26880, 320, 5
LINEAR_CHECK_VOXELS, LINEAR_F64_RTOL = 256, 1e-4


def phase(name):
    print(f"[phase] {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def optional_packages() -> str:
    """The versions of the packages the port imports only on demand, then
    whether the data-layer packages are installed (read from their
    metadata, without importing them: the port must not need pandas)."""
    import importlib
    import importlib.metadata
    import importlib.util

    found = []
    for name in ("transformers", "tensorboard", "matplotlib", "seaborn"):
        try:
            found.append(f"{name} {importlib.import_module(name).__version__}")
        except ImportError:
            found.append(f"{name} absent")
    for name in ("pandas", "scipy", "soundfile", "nibabel", "nilearn"):
        if importlib.util.find_spec(name) is None:
            found.append(f"{name} absent")
            continue
        try:
            found.append(f"{name} {importlib.metadata.version(name)}")
        except importlib.metadata.PackageNotFoundError:
            found.append(f"{name} present")
    return ", ".join(found)


def make_times(rng, t_w, t_tr, span):
    data_times = np.sort(rng.uniform(0, span, t_w)).astype(np.float32)
    tr_times = (np.arange(t_tr, dtype=np.float32) * (span / t_tr)
                + span / t_tr / 2)
    return data_times, tr_times


def cuda_time_ms(fn, runs=30, warmup=5):
    """Median over `runs` single calls, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def back_to_back_ms(launchers, rounds=TIMING_ROUNDS, repeats=5):
    """Device ms per launch: rounds x len(launchers) launches back to back
    between one pair of CUDA events, cycling over `launchers` (each with
    its own operands), divided by their number; the median of `repeats`
    such runs. Only runs in which the host enqueued every launch before
    the spin kernel released the stream are kept, so the device never
    waited on the host: a run that missed is discarded and repeated with
    the hold doubled, and the function raises once the hold has been
    doubled MAX_HOLD_DOUBLINGS times and the host still outran it."""
    import torch

    for fn in launchers:
        fn()
    hold = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n = rounds * len(launchers)
    hold_cycles, doublings = HOLD_CYCLES, 0
    times = []
    while len(times) < repeats:
        torch.cuda.synchronize()
        hold.record()
        torch.cuda._sleep(hold_cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(rounds):
            for fn in launchers:
                fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        hold_ms = hold.elapsed_time(start)
        if host_ms >= hold_ms:
            if doublings == MAX_HOLD_DOUBLINGS:
                raise AssertionError(
                    f"enqueueing {n} launches took {host_ms:.2f} ms, longer "
                    f"than the {hold_ms:.2f} ms hold of {hold_cycles} cycles")
            print(f"  enqueueing {n} launches took {host_ms:.2f} ms, longer "
                  f"than the {hold_ms:.2f} ms hold: run discarded, hold "
                  f"doubled to {2 * hold_cycles} cycles")
            hold_cycles, doublings = 2 * hold_cycles, doublings + 1
            continue
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def main_shape_cases(rng):
    """(label, data, word times, TR times) at the main shape: sorted word
    times; the same permuted; a story with a silent gap of GAP_SECONDS
    (TR tiles with no live word); descending TR times (negative cutoff)."""
    t_w, dim, t_tr = (MAIN_SHAPE[k] for k in ("t_w", "dim", "t_tr"))
    span = t_tr * TR_SECONDS
    data = rng.normal(size=(t_w, dim)).astype(np.float32)
    dt, tt = make_times(rng, t_w, t_tr, span)
    perm = rng.permutation(t_w)
    gap_dt = np.sort(rng.uniform(0, span - GAP_SECONDS, t_w)).astype(
        np.float32)
    gap_dt[gap_dt >= (span - GAP_SECONDS) / 2] += np.float32(GAP_SECONDS)
    return [
        ("main", data, dt, tt),
        ("main, word times permuted", data[perm], dt[perm], tt),
        (f"main, {GAP_SECONDS:.0f} s silent gap", data, gap_dt, tt),
        ("main, descending TR times", data, dt, tt[::-1].copy()),
    ]


def time_shape(device, data_np, dt_np, tt_np, delays, n_sets):
    """Times and bound of the kernel at one shape: back to back over
    `n_sets` operand sets each with its own copy of every operand, single
    calls, the plain version, and torch.matmul(K_all, data) with the
    shifted weights precomputed."""
    import torch

    from litcoder_core_torch.ops import lanczos_fir as lf
    from litcoder_core_torch.ops.interp import lanczos_matrix

    (t_w, dim), t_tr = data_np.shape, tt_np.shape[0]
    data = torch.as_tensor(data_np, device=device)
    dt = torch.as_tensor(dt_np, device=device)
    tt = torch.as_tensor(tt_np, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    K_all = lf.shifted_lanczos_stack(dt, tt, delays, 3, 1.0)
    kernel_sets, library_sets = [], []
    for _ in range(n_sets):
        d = torch.randn((t_w, dim), device=device, generator=gen)
        dt_i, tt_i = dt.clone(), tt.clone()
        kernel_sets.append((d, dt_i, tt_i)
                           + lf.prepare_launch(d, dt_i, tt_i, delays, 1.0))
        library_sets.append((K_all.clone(), d.clone(), torch.empty(
            (len(delays) * t_tr, dim), device=device)))
    rounds = TIMING_ROUNDS * TIMING_SETS // n_sets
    ms = back_to_back_ms([lambda s=s: lf.launch(*s, 3) for s in kernel_sets],
                         rounds=rounds)
    library_ms = back_to_back_ms(
        [lambda s=s: torch.matmul(s[0], s[1], out=s[2])
         for s in library_sets], rounds=rounds)
    del kernel_sets, library_sets
    cutoff, delays_t, out = lf.prepare_launch(data, dt, tt, delays, 1.0)
    ms_single = cuda_time_ms(lambda: lf.launch(data, dt, tt, cutoff,
                                               delays_t, out, 3))
    library_single = cuda_time_ms(lambda: torch.matmul(K_all, data))
    plain_ms = cuda_time_ms(
        lambda: lf.lanczos_fir_reference(data, dt, tt, delays, 3, 1.0))

    # Least time for the same work: each input read once and the output
    # written once, against the FMAs the nonzero Lanczos weights need.
    nnz = int((lanczos_matrix(dt, tt, 3, 1.0) != 0).sum())
    n_bytes = 4 * (t_w * dim + t_w + t_tr + t_tr * len(delays) * dim)
    n_ops = 2 * nnz * dim
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_F32_FLOP_PER_S * 1e3
    timing = {
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "ms_single_call": ms_single,
        "library_ms_single_call": library_single,
    }
    print(f"  t_w={t_w} t_tr={t_tr} d={dim} delays={delays}, back to back "
          f"over {n_sets} operand sets: kernel {ms:.5f} ms "
          f"({timing['bound_ms'] / ms:.1%} of the bound), matmul(K_all, "
          f"data) {library_ms:.5f} ms; single calls: kernel "
          f"{ms_single:.5f} ms, matmul {library_single:.5f} ms, plain "
          f"{plain_ms:.5f} ms; bound {timing['bound_ms']:.5f} ms "
          f"({timing['bound_by']}: {n_bytes} bytes, {n_ops} flop from "
          f"{nnz} nonzero weights)", flush=True)
    return timing


def narratives_shape(rng):
    """Word features, word times and TR times of one 21styear-shaped
    story."""
    data = rng.normal(size=(NARR_WORDS, MAIN_SHAPE["dim"])).astype(
        np.float32)
    dt, tt = make_times(rng, NARR_WORDS, NARR_TR, NARR_TR * NARR_TR_SECONDS)
    return data, dt, tt


def speech_shape(rng):
    """Frame features, frame end times and TR times of phase 13's speech
    extraction (float64 times, as the extractor gives them)."""
    data = rng.normal(size=(SPEECH_FRAMES, MAIN_SHAPE["dim"])).astype(
        np.float32)
    dt = SPEECH_FIRST_FRAME + SPEECH_STRIDE * np.arange(SPEECH_FRAMES)
    tt = np.arange(SPEECH_TR) * SPEECH_TR_SECONDS
    return data, dt, tt


def check_dead_rows(got, dt, tt, delays):
    """Where no frame reaches a TR (the shifted Lanczos row is all zero),
    the kernel's output block must be exactly zero; returns (zero blocks,
    TR rows that are zero in every block)."""
    from litcoder_core_torch.ops import lanczos_fir as lf

    t_tr, n_d = tt.shape[0], len(delays)
    dead = (lf.shifted_lanczos_stack(dt, tt, delays, 3, 1.0) == 0).all(
        dim=1).reshape(n_d, t_tr)
    blocks = got.reshape(t_tr, n_d, -1).permute(1, 0, 2)
    nonzero = int((blocks[dead] != 0).sum())
    if not dead[:, 0].all() or nonzero:
        raise AssertionError(f"{nonzero} nonzero values where no frame "
                             "reaches the TR")
    return int(dead.sum()), int(dead.all(dim=0).sum())


def kernel_phase(device):
    """Kernel vs plain version on the card; times at the main, the
    Narratives and the speech shapes."""
    import torch

    from litcoder_core_torch.ops import lanczos_fir as lf

    rng = np.random.default_rng(0)
    cases = [(label, MAIN_SHAPE["delays"], data, dt, tt)
             for label, data, dt, tt in main_shape_cases(rng)]
    for label, shapes in (("test shape", TEST_SHAPES),
                          ("path shape", PATH_SHAPES)):
        for t_w, dim, t_tr, delays, span in shapes:
            data = rng.normal(size=(t_w, dim)).astype(np.float32)
            dt, tt = make_times(rng, t_w, t_tr, span)
            cases.append((label, delays, data, dt, tt))
    narr = narratives_shape(np.random.default_rng(1))
    cases.append(("Narratives 21styear shape", NARR_DELAYS) + narr)
    speech = speech_shape(np.random.default_rng(2))
    cases.append(("speech shape", NARR_DELAYS) + speech)
    max_err = 0.0
    for label, delays, data_np, dt_np, tt_np in cases:
        data = torch.as_tensor(data_np, device=device)
        dt = torch.as_tensor(dt_np, device=device, dtype=torch.float32)
        tt = torch.as_tensor(tt_np, device=device, dtype=torch.float32)
        got = lf.lanczos_fir(data, dt, tt, delays, window=3, cutoff_mult=1.0,
                             device=device)
        ref = lf.lanczos_fir_reference(data, dt, tt, delays, 3, 1.0)
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            raise AssertionError(f"shape {tuple(got.shape)} != "
                                 f"{tuple(ref.shape)}")
        err = float((got - ref).abs().max())
        live = lf.live_word_tiles(dt, tt)
        line = (f"  kernel vs plain, {label} t_w={data.shape[0]} "
                f"d={data.shape[1]} t_tr={tt.shape[0]} delays={delays}: "
                f"max_abs_err={err:.3e}; word tiles visited per column slab "
                f"{int(live.sum())} of {live.numel()} dense")
        if label == "speech shape":
            blocks, rows = check_dead_rows(got, dt, tt, delays)
            dead_tiles = int((live.sum(1) == 0).sum())
            line += (f"; TR tiles with no frame {dead_tiles}, live tiles "
                     f"of the first four "
                     f"{live.sum(1)[:4].tolist()}; {blocks} (TR, delay) "
                     f"blocks no frame reaches and {rows} TR rows exactly "
                     f"zero")
        print(line, flush=True)
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"by {err} > {KERNEL_ATOL}")
        max_err = max(max_err, err)
        del got, ref

    print("  times at the main shape:", flush=True)
    _, data_np, dt_np, tt_np = main_shape_cases(rng)[0]
    record = {
        "name": "lanczos_fir",
        "route": "cuda",
        "source": "litcoder_core_torch/csrc/lanczos_fir.cu",
        "replaces": "litcoder_core_tpu/ops/pallas_kernels.py:33",
        "launches": None,
        "max_abs_err": max_err,
    }
    record.update(time_shape(device, data_np, dt_np, tt_np,
                             MAIN_SHAPE["delays"], TIMING_SETS))
    print("  times at the Narratives 21styear shape:", flush=True)
    record["narratives_shape"] = time_shape(device, *narr, NARR_DELAYS,
                                            NARR_TIMING_SETS)
    print("  times at the speech shape:", flush=True)
    data_np, dt_np, tt_np = speech
    record["speech_shape"] = time_shape(
        device, data_np, dt_np.astype(np.float32), tt_np.astype(np.float32),
        NARR_DELAYS, SPEECH_TIMING_SETS)
    return record


def make_story(rng, name, n_tr, words_per_s, vocab, emb, proj, mix,
               noise_std, n_vox, story_cls, signal_out=None,
               tr_seconds=TR_SECONDS, delays=(1, 2, 3, 4), lebel=True):
    """One synthetic story: word times at ~words_per_s, brain data carrying
    a low-rank signal of the delayed Lanczos-downsampled embeddings plus
    Gaussian noise. LeBel layout: n_tr - 15 rows, row i answering TR i + 10;
    otherwise (Narratives, LPP) one row per TR."""
    import torch

    from litcoder_core_torch.ops.lanczos_fir import lanczos_fir_reference

    span = n_tr * tr_seconds
    n_words = int(rng.integers(int(0.95 * span * words_per_s),
                               int(1.05 * span * words_per_s)))
    data_times = np.sort(rng.uniform(0, span, n_words)).astype(np.float32)
    tr_times = (np.arange(n_tr) * tr_seconds + tr_seconds / 2).astype(
        np.float32)
    word_ids = rng.integers(0, len(vocab), n_words)
    words = [vocab[i] for i in word_ids]
    split = np.clip((data_times // tr_seconds).astype(int), 0, n_tr - 1)
    low = torch.as_tensor(emb[word_ids] @ proj)
    feats = lanczos_fir_reference(low, torch.as_tensor(data_times),
                                  torch.as_tensor(tr_times), delays).numpy()
    signal = feats @ mix
    if lebel:
        signal = signal[10:n_tr - 5]
    brain = signal + noise_std * rng.standard_normal(signal.shape,
                                                     dtype=np.float32)
    if signal_out is not None:
        signal_out.append(float(signal.var()))
    return story_cls(
        name=name, brain_data=brain.astype(np.float32), stimuli=words,
        split_indices=split.tolist(), tr_times=tr_times,
        data_times=data_times,
        word_rates=np.bincount(split, minlength=n_tr).astype(np.float32),
        words=words,
    )


def build_assembly(seed, n_stories, n_tr, emb_dim, n_vox, vocab_size,
                   kv_path, noise_std, tr_seconds=TR_SECONDS,
                   delays=(1, 2, 3, 4), lebel=True):
    """Assembly plus a .kv bundle of random embeddings at kv_path; returns
    (assembly, planted-signal ceiling on r)."""
    from litcoder_core_torch import SimpleNeuroidAssembly, StoryData
    from litcoder_core_torch.features.embeddings import SimpleKeyedVectors

    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(vocab_size)]
    emb = rng.standard_normal((vocab_size, emb_dim), dtype=np.float32)
    SimpleKeyedVectors(vocab, emb).save_kv(kv_path)
    proj = (rng.standard_normal((emb_dim, SIGNAL_RANK), dtype=np.float32)
            / np.sqrt(emb_dim))
    n_mix = len(delays) * SIGNAL_RANK
    mix = (rng.standard_normal((n_mix, n_vox), dtype=np.float32)
           / np.sqrt(n_mix))
    signal_var = []
    stories = [
        make_story(rng, f"story{i:03d}", n_tr, WORDS_PER_S, vocab, emb,
                   proj, mix, noise_std, n_vox, StoryData, signal_var,
                   tr_seconds, delays, lebel)
        for i in range(n_stories)
    ]
    s2 = float(np.mean(signal_var))
    return (SimpleNeuroidAssembly(
                stories, validation_method="outer" if lebel else "inner"),
            float(np.sqrt(s2 / (s2 + noise_std**2))))


def make_trainer(assembly, kv_path, device, results_dir, full_cv=False,
                 delays=(1, 2, 3, 4), downsample_config=None):
    """The port's trainer with one static-embedding extractor: LeBel
    train/test structuring, or with `full_cv` the Narratives concatenation
    (the fit's full nested-CV mode); Lanczos downsampling unless
    `downsample_config` names another method."""
    from litcoder_core_torch import (
        AbstractTrainer,
        Downsampler,
        FeatureExtractorFactory,
        NestedCVModel,
    )

    emb = FeatureExtractorFactory.create_extractor(
        "embeddings", "random-static", {"vector_path": kv_path,
                                        "lowercase": False})
    return AbstractTrainer(
        assembly=assembly,
        feature_extractors=[emb],
        downsampler=Downsampler(),
        model=NestedCVModel(seed=0, device=device),
        fir_delays=list(delays),
        trimming_config=dict(NARR_TRIM if full_cv else LEBEL_TRIM),
        use_train_test_split=not full_cv,
        dataset_type="narratives" if full_cv else "lebel",
        logger_backend="none",
        results_dir=results_dir,
        downsample_config=downsample_config or {
            "method": "lanczos", "window": 3, "cutoff_mult": 1.0},
        device=device,
    )


def check_metrics(metrics, n_vox, alphas_grid, paths=EXPECTED_PATHS):
    """Finite correlations and p-values of the right shape, alphas from the
    grid (full CV: means over the outer folds, so inside its range), the
    full-CV keys, and the expected solver paths."""
    corr = np.asarray(metrics["correlations"])
    if corr.shape != (n_vox,) or not np.all(np.isfinite(corr)):
        raise AssertionError(f"correlations: shape {corr.shape}, finite "
                             f"{np.isfinite(corr).all()}")
    p = np.asarray(metrics["p_values"])
    if not (np.all(np.isfinite(p)) and np.all((p >= 0) & (p <= 1))):
        raise AssertionError("p-values not finite in [0, 1]")
    alphas = np.asarray(metrics["best_alphas"], np.float32)
    grid = np.asarray(alphas_grid, np.float32)
    if paths["mode"] == "train_test":
        if not np.all(np.isin(alphas, grid)):
            raise AssertionError("best alphas outside the grid")
    else:
        if not (np.all(alphas >= grid.min()) and np.all(alphas <= grid.max())):
            raise AssertionError("mean alphas outside the grid's range")
        missing = FULL_CV_KEYS - set(metrics)
        if missing:
            raise AssertionError(f"full-CV metrics lack {sorted(missing)}")
    if metrics["solver_paths"] != paths:
        raise AssertionError(f"solver_paths {metrics['solver_paths']}, "
                             f"expected {paths}")


def card_vs_cpu(label, make_trainer_on, paths, fit):
    """Train make_trainer_on(device) on the card and on the CPU; same
    alphas, correlations within 2e-3, median r within 1e-3, the expected
    solver paths on both."""
    from litcoder_core_torch.ops import lanczos_fir as lf

    results = {}
    for device in ("cuda", "cpu"):
        before = lf.launches
        results[device] = make_trainer_on(device).train(**fit)
        n_vox = len(results[device]["correlations"])
        check_metrics(results[device], n_vox, np.logspace(-1, 8, 10), paths)
        print(f"  {label}, {device}: median r "
              f"{results[device]['median_score']:.6f}, solver_paths "
              f"{results[device]['solver_paths']}, kernel launches "
              f"{lf.launches - before}", flush=True)
    gpu, cpu = results["cuda"], results["cpu"]
    if gpu["best_alphas"] != cpu["best_alphas"]:
        raise AssertionError(f"{label}: card and CPU selected different "
                             "alphas")
    dr = float(np.max(np.abs(np.asarray(gpu["correlations"])
                             - np.asarray(cpu["correlations"]))))
    dm = abs(gpu["median_score"] - cpu["median_score"])
    print(f"  {label}, card vs CPU: same alphas, max |dr| {dr:.3e} (bar "
          f"2e-3), |d median| {dm:.3e} (bar 1e-3)", flush=True)
    if dr > 2e-3 or dm > 1e-3:
        raise AssertionError(f"{label}: card and CPU correlations disagree")


def embedding_trainers(asm, kv_path, workdir, label, full_cv=False,
                       delays=(1, 2, 3, 4)):
    """make_trainer_on(device) for card_vs_cpu: make_trainer's static-
    embedding trainer with its results in workdir/<label>_<device>."""
    return lambda device: make_trainer(
        asm, kv_path, device, os.path.join(workdir, f"{label}_{device}"),
        full_cv, delays)


def small_parity_phase(workdir):
    """The port's trainer on small assemblies, on the card and the CPU: the
    LeBel train/test split, then the concatenated full-CV mode on its fused
    route (tall features, chunked folds) and its per-fold route (wide
    features, kfold_trimmed folds: the dual search)."""
    kv_path = os.path.join(workdir, "small.kv")
    asm, _ = build_assembly(1, 4, 120, 6, 40, 400, kv_path, 1.0)
    card_vs_cpu("train/test",
                embedding_trainers(asm, kv_path, workdir, "train/test"),
                EXPECTED_PATHS, dict(chunk_length=10, n_inner_folds=3))

    kv_path = os.path.join(workdir, "small_tall.kv")
    asm, _ = build_assembly(2, 4, 120, 6, 40, 400, kv_path, 1.0,
                            lebel=False)
    card_vs_cpu("full CV, tall chunked",
                embedding_trainers(asm, kv_path, workdir, "full CV, tall "
                                   "chunked", full_cv=True),
                FUSED_PATHS,
                dict(chunk_length=10, n_outer_folds=3, n_inner_folds=3))

    # 2 x 150 TRs trimmed 14:-9: 277 rows, about 177 inner train rows for
    # 48 x 8 = 384 features.
    kv_path = os.path.join(workdir, "small_wide.kv")
    asm, _ = build_assembly(3, 2, 150, 48, 40, 400, kv_path, 1.0,
                            tr_seconds=NARR_TR_SECONDS, delays=NARR_DELAYS,
                            lebel=False)
    card_vs_cpu("full CV, wide kfold_trimmed",
                embedding_trainers(asm, kv_path, workdir, "full CV, wide "
                                   "kfold_trimmed", full_cv=True,
                                   delays=NARR_DELAYS),
                PER_FOLD_DUAL_PATHS, dict(NARR_FIT))


def small_problem(seed, T=400, Tp=100, D=12, V=40):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T, D)).astype(np.float32)
    W = (rng.normal(size=(D, V)) * rng.uniform(0.05, 0.5, V)
         / np.sqrt(max(D / 12, 1.0))).astype(np.float32)
    Y = (X @ W + rng.normal(size=(T, V))).astype(np.float32)
    Xt = rng.normal(size=(Tp, D)).astype(np.float32)
    Yt = (Xt @ W + rng.normal(size=(Tp, V))).astype(np.float32)
    return X, Y, Xt, Yt


def solver_cases_phase():
    """fit_nested_cv on the card and on the CPU through every search path
    the trainer cases above do not take."""
    from litcoder_core_torch import fit_nested_cv

    problems = {"tall": small_problem(11),
                "wide": small_problem(12, T=200, Tp=60, D=240)}
    problems["full"] = problems["tall"][:2]
    for label, problem, kw, paths in SOLVER_CASES:
        fit = dict(SMALL_FIT, **kw)
        got = {device: fit_nested_cv(*problems[problem], device=device, **fit)
               for device in ("cuda", "cpu")}
        (mg, _, ag), (mc, _, ac) = got["cuda"], got["cpu"]
        for device, (m, _, _) in got.items():
            if m["solver_paths"] != paths:
                raise AssertionError(f"{label}, {device}: solver_paths "
                                     f"{m['solver_paths']}, expected {paths}")
        dr = float(np.max(np.abs(np.asarray(mg["correlations"])
                                 - np.asarray(mc["correlations"]))))
        dm = abs(mg["median_score"] - mc["median_score"])
        line = (f"  {label}: {paths['alpha_search']}/{paths['fast_scan']} "
                f"on both, same alphas {bool(np.array_equal(ag, ac))}, max "
                f"|dr| {dr:.3e}, |d median| {dm:.3e}")
        if "significance" in kw:
            same_p = mg["p_values"] == mc["p_values"]
            line += f", identical permutation p-values {same_p}"
            if not same_p or mg.get("significance_method") != "permutation":
                raise AssertionError(f"{label}: card and CPU p-values differ")
        print(line, flush=True)
        if not np.array_equal(ag, ac) or dr > 2e-3 or dm > 1e-3:
            raise AssertionError(f"{label}: card and CPU fits disagree")


STEP_LOGGER = "litcoder_core_torch.parallel.step"


def check_step_result(label, result, n_vox, grid):
    """Host copies (correlations, p-values, alphas, weights) of a
    NestedCVResult: finite, the right shapes, alphas from the grid."""
    from litcoder_core_torch.utils.device import to_numpy

    corr, p, alphas, weights = (to_numpy(t) for t in result)
    if corr.shape != (n_vox,) or alphas.shape != (n_vox,) \
            or weights.shape[1] != n_vox:
        raise AssertionError(f"{label}: shapes {corr.shape} {alphas.shape} "
                             f"{weights.shape}")
    if not (np.all(np.isfinite(corr)) and np.all(np.isfinite(weights))
            and np.all((p >= 0) & (p <= 1))):
        raise AssertionError(f"{label}: non-finite results")
    if not np.all(np.isin(alphas, np.asarray(grid, np.float32))):
        raise AssertionError(f"{label}: alphas outside the grid")
    return corr, p, alphas, weights


def step_cases_phase():
    """nested_cv_step on the card and on the CPU through each scan and
    refit: the route each took (from the step's log line), the same alphas,
    correlations within STEP_ATOL."""
    from litcoder_core_torch.parallel.step import (equal_size_folds,
                                                   nested_cv_step)

    X, Y, Xt, Yt = small_problem(13, T=STEP_T)
    grid = np.logspace(-1, 8, 10).astype(np.float32)
    tr, va = equal_size_folds(STEP_T, STEP_FOLDS, STEP_CHUNK, seed=0)
    rem = np.setdiff1d(np.arange(STEP_T), va.ravel())
    folds = {"equal": (tr, va),
             "noncomp": (np.concatenate(
                 [tr, np.broadcast_to(rem, (len(tr), rem.size))], axis=1),
                 va)}
    for label, kind, kw, route in STEP_CASES:
        got = {}
        for device in ("cuda", "cpu"):
            with LogLines(STEP_LOGGER, "nested_cv_step:") as log:
                result = nested_cv_step(X, Y, Xt, Yt, grid, *folds[kind],
                                        device=device, **kw)
            if log.messages != [f"nested_cv_step: {route}"]:
                raise AssertionError(f"{label}, {device}: logged "
                                     f"{log.messages}, expected {route}")
            got[device] = check_step_result(label, result, Y.shape[1], grid)
        (rg, pg, ag, wg), (rc, pc, ac, wc) = got["cuda"], got["cpu"]
        dr = float(np.max(np.abs(rg - rc)))
        dw = float(np.max(np.abs(wg - wc)) / np.max(np.abs(wc)))
        print(f"  step {label}: {route} on both, same alphas "
              f"{bool(np.array_equal(ag, ac))}, max |dr| {dr:.3e} (bar "
              f"{STEP_ATOL}), max |dp| {float(np.max(np.abs(pg - pc))):.3e}, "
              f"max |dw| / max |w| {dw:.3e}", flush=True)
        if not np.array_equal(ag, ac) or dr > STEP_ATOL:
            raise AssertionError(f"step {label}: card and CPU disagree")
        if kw.get("single_alpha") and np.unique(ag).size != 1:
            raise AssertionError("single_alpha selected several alphas")


def downsample_inputs(data, data_times, tr_times, split):
    """The keyword arguments of every Downsampler method for one story;
    the legacy methods get the np.split boundaries of the per-word ids."""
    split = np.asarray(split)
    boundaries = np.flatnonzero(np.diff(split)) + 1
    out = {}
    for method, kw in DOWNSAMPLE_KWARGS.items():
        kw = dict(kw)
        if method in ("average", "sum", "last"):
            kw["split_indices"] = split
        elif method.startswith("legacy"):
            kw["split_indices"] = boundaries
        out[method] = kw
    return out


def downsample_cases(label, data, data_times, tr_times, split, rtol,
                     timed=False):
    """Every Downsampler method on the card against the CPU, within rtol of
    the CPU's largest magnitude and with the same shape; with `timed`, the
    card's ms per call (median of 30 calls, each between two CUDA events,
    inputs already on the card)."""
    import torch

    from litcoder_core_torch import Downsampler

    ds = Downsampler()
    dev = torch.device("cuda")
    on_card = [torch.as_tensor(a, device=dev)
               for a in (data, data_times, tr_times)]
    parts = []
    for method, kw in downsample_inputs(data, data_times, tr_times,
                                        split).items():
        cpu = ds.downsample(data, data_times, tr_times, method=method,
                            device="cpu", **kw)
        card = ds.downsample(*on_card, method=method, device=dev, **kw)
        if card.device.type != "cuda" or card.shape != cpu.shape:
            raise AssertionError(f"{label} {method}: {card.device} "
                                 f"{tuple(card.shape)} vs {tuple(cpu.shape)}")
        err = float((card.cpu() - cpu).abs().max())
        scale = float(cpu.abs().max())
        part = (f"{method} {tuple(cpu.shape)} err {err:.2e} "
                f"({err / scale:.2e} of max |CPU|)")
        if timed:
            ms = cuda_time_ms(lambda: ds.downsample(
                *on_card, method=method, device=dev, **kw))
            part += f" {ms:.4f} ms"
        parts.append(part)
        if not err <= rtol * scale:
            raise AssertionError(f"{label} {method}: card and CPU differ by "
                                 f"{err} > {rtol} x {scale}")
    print(f"  downsampling, {label}, card vs CPU (bar {rtol} x max |CPU|): "
          + "; ".join(parts), flush=True)


def small_downsample_phase():
    """The ten methods on one small story: 230 words over 49 TRs of 2 s,
    the last TRs without a word."""
    rng = np.random.default_rng(4)
    data = rng.normal(size=(230, 16)).astype(np.float32)
    data_times = np.sort(rng.uniform(0, 90, 230)).astype(np.float32)
    tr_times = (np.arange(49) * 2.0 + 1.0).astype(np.float32)
    downsample_cases("small story", data, data_times, tr_times,
                     (data_times // 2).astype(int), 1e-5)


def report_path_run(metrics, wall, peak, smi_line, floor):
    """Prints a trainer run; the median r must beat `floor` unless it is
    None."""
    print(f"  trainer_stage_seconds {json.dumps(metrics['trainer_stage_seconds'])}"
          f" (train() wall {wall:.3f} s)", flush=True)
    print(f"  median r {metrics['median_score']:.6f} "
          f"({'no floor' if floor is None else f'floor {floor}'}), "
          f"n_significant {metrics['n_significant']}", flush=True)
    print(f"  solver_paths {metrics['solver_paths']}", flush=True)
    print(f"  max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB), "
          f"card: {smi_line}", flush=True)
    if floor is not None and not metrics["median_score"] > floor:
        raise AssertionError(f"median r {metrics['median_score']} <= {floor}")


def main_path_phase(workdir, smi_line):
    import torch

    from litcoder_core_torch.ops import lanczos_fir as lf

    kv_path = os.path.join(workdir, "emb768.kv")
    t0 = time.perf_counter()
    asm, ceiling = build_assembly(zlib.crc32(b"lebel-uts03"), N_STORIES,
                                  N_TR, EMB_DIM, N_VERTICES, VOCAB, kv_path,
                                  NOISE_STD)
    print(f"  synthetic assembly: {N_STORIES} stories x {N_TR} TRs, "
          f"{N_VERTICES} vertices, ceiling r {ceiling:.4f}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    trainer = make_trainer(asm, kv_path, "cuda",
                           os.path.join(workdir, "results"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lf.launches = 0
    t0 = time.perf_counter()
    metrics = trainer.train(chunk_length=20, n_inner_folds=5)
    wall = time.perf_counter() - t0
    launches = lf.launches
    peak = torch.cuda.max_memory_allocated()

    check_metrics(metrics, N_VERTICES, np.logspace(-1, 8, 10))
    print(f"  lanczos_fir launches {launches}", flush=True)
    report_path_run(metrics, wall, peak, smi_line, MEDIAN_R_FLOOR)
    if launches < N_STORIES:
        raise AssertionError(f"the kernel ran {launches} times, fewer than "
                             f"the {N_STORIES} stories")
    return launches, asm, kv_path


def narratives_phase(workdir, smi_line):
    """One 21styear-shaped story through AbstractTrainer.train() in
    concatenated full nested-CV mode at GPT-2-small width."""
    import torch

    from litcoder_core_torch.ops import lanczos_fir as lf

    kv_path = os.path.join(workdir, "narr768.kv")
    t0 = time.perf_counter()
    asm, ceiling = build_assembly(zlib.crc32(b"narratives-21styear"), 1,
                                  NARR_TR, EMB_DIM, N_VERTICES, VOCAB,
                                  kv_path, NARR_NOISE_STD,
                                  tr_seconds=NARR_TR_SECONDS,
                                  delays=NARR_DELAYS, lebel=False)
    print(f"  synthetic story: {NARR_TR} TRs of {NARR_TR_SECONDS} s, "
          f"{len(asm.get_words()[0])} words, {N_VERTICES} vertices, "
          f"D = {EMB_DIM} x {len(NARR_DELAYS)}, ceiling r {ceiling:.4f}, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    trainer = make_trainer(asm, kv_path, "cuda",
                           os.path.join(workdir, "narr_results"),
                           full_cv=True, delays=NARR_DELAYS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lf.launches = 0
    t0 = time.perf_counter()
    metrics = trainer.train(**NARR_FIT)
    wall = time.perf_counter() - t0
    launches = lf.launches
    peak = torch.cuda.max_memory_allocated()

    check_metrics(metrics, N_VERTICES, np.logspace(-1, 8, 10),
                  PER_FOLD_DUAL_PATHS)
    print(f"  lanczos_fir launches {launches}; n_majority_significant "
          f"{metrics['n_majority_significant']}", flush=True)
    report_path_run(metrics, wall, peak, smi_line, NARR_MEDIAN_R_FLOOR)
    if launches < 1:
        raise AssertionError("the kernel did not run on the Narratives path")
    return launches


def signal_problem(n_rows, n_voxels, seed, n_null=0):
    """X (n_rows, D) normal and Y = X W M + unit noise, W (D, 256) / sqrt(D)
    and M (256, V) / 16 (benchmarks/full_cv.py, benchmarks/northstar.py),
    built on the card from a seed; the first n_null columns of M are zeroed
    after the draw, so those voxels are pure noise and the rest unchanged."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((n_rows, FUSED_D), device=dev, generator=gen)
    W = torch.randn((FUSED_D, FUSED_RANK), device=dev,
                    generator=gen) / FUSED_D ** 0.5
    M = torch.randn((FUSED_RANK, n_voxels), device=dev,
                    generator=gen) / FUSED_RANK ** 0.5
    M[:, :n_null] = 0.0
    Y = (X @ W) @ M
    Y += torch.randn(Y.shape, device=dev, generator=gen)
    return X, Y


def timed_fit(label, smi_line, *args, **kw):
    """NestedCVModel(device='cuda').fit_predict with its wall (synchronized)
    and peak device memory (the data included); prints both."""
    import torch

    from litcoder_core_torch import NestedCVModel

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit = {"chunk_length": FUSED_CHUNK, "n_inner_folds": 5,
           "return_weights": False, **kw}
    model = NestedCVModel(seed=0, device="cuda")
    metrics, weights, alphas = model.fit_predict(*args, **fit)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if weights is not None:
        raise AssertionError("return_weights=False returned weights")
    corr = np.asarray(metrics["correlations"])
    p = np.asarray(metrics["p_values"])
    if not (np.all(np.isfinite(corr)) and np.all((p >= 0) & (p <= 1))):
        raise AssertionError(f"{label}: non-finite correlations or p-values")
    print(f"  {label}: fit_predict wall {wall:.3f} s, median r "
          f"{metrics['median_score']:.6f}, n_significant "
          f"{metrics['n_significant']}, solver_paths "
          f"{metrics['solver_paths']}, max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB), card: {smi_line}", flush=True)
    return metrics, alphas


def agreement(label, alphas_a, alphas_b, metrics_a, metrics_b, min_share,
              corr_atol, where_same=True):
    """Share of voxels with the same alpha (at least min_share) and the
    largest correlation gap (where the alphas agree, or everywhere)."""
    same = np.asarray(alphas_a) == np.asarray(alphas_b)
    gap = np.abs(np.asarray(metrics_a["correlations"])
                 - np.asarray(metrics_b["correlations"]))
    dr = float(np.max(gap[same] if where_same else gap, initial=0.0))
    dm = abs(metrics_a["median_score"] - metrics_b["median_score"])
    print(f"  {label}: same alpha on {int(same.sum())} of {same.size} "
          f"voxels ({same.mean():.4%}; {int((~same).sum())} differ), max "
          f"|dr| {dr:.3e}{' where they agree' if where_same else ''}, "
          f"|d median| {dm:.3e}", flush=True)
    if same.mean() < min_share or dr > corr_atol:
        raise AssertionError(f"{label}: the fits disagree")
    return dm


def fused_full_cv_phase(smi_line):
    """The benchmarks/full_cv.py problem through NestedCVModel.fit_predict
    in full nested-CV mode: the fused route at full size, whole and in
    voxel chunks."""
    X, Y = signal_problem(FUSED_T, N_VERTICES, 0)
    results = {}
    for chunk in (None, NS_CHUNK):
        label = (f"T={FUSED_T} D={FUSED_D} V={N_VERTICES}, "
                 f"voxel_chunk_size={chunk}")
        metrics, alphas = timed_fit(label, smi_line, X, Y, n_outer_folds=5,
                                    voxel_chunk_size=chunk)
        check_metrics(metrics, N_VERTICES, np.logspace(-1, 8, 10),
                      FUSED_PATHS)
        print(f"  n_majority_significant {metrics['n_majority_significant']}"
              f" (median r floor {FUSED_MEDIAN_R_FLOOR})", flush=True)
        if not metrics["median_score"] > FUSED_MEDIAN_R_FLOOR:
            raise AssertionError(f"median r {metrics['median_score']} <= "
                                 f"{FUSED_MEDIAN_R_FLOOR}")
        results[chunk] = metrics, alphas
    agreement("chunked vs whole (mean alphas over the folds)",
              results[NS_CHUNK][1], results[None][1], results[NS_CHUNK][0],
              results[None][0], 0.999, 1e-4)


# Kernel families of a fit's device time, by substrings of kernel names.
KERNEL_FAMILIES = (("gemm", ("gemm", "gemv", "cutlass", "sm90_xmma")),
                   ("cholesky", ("potrf",)), ("triangular solve", ("trsm",)),
                   ("eigh", ("syev", "stedc", "sytrd", "ormtr", "steqr",
                             "larft", "larfb")),
                   ("fft", ("fft",)))


def profile_fit(label, smi_line, *args, **kw):
    """One more fit under torch.profiler: device time of every CUDA kernel,
    summed by family, the busiest kernels, and their sum over the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timed_fit(f"{label} under torch.profiler", smi_line, *args, **kw)
        wall = time.perf_counter() - t0
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
    total = sum(by_name.values())
    families = {}
    for name, ms in by_name.items():
        family = next((f for f, keys in KERNEL_FAMILIES
                       if any(k in name.lower() for k in keys)), "other")
        families[family] = families.get(family, 0.0) + ms
    ranked = dict(sorted(families.items(), key=lambda item: -item[1]))
    print(f"  {label}, profiled: wall {wall:.3f} s, CUDA kernel time "
          f"{total:.1f} ms ({total / 1e3 / wall:.1%} of the wall) in "
          f"{len(by_name)} kernel names; by family (ms): "
          f"{json.dumps({f: round(ms, 1) for f, ms in ranked.items()})}",
          flush=True)
    for name, ms in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
        print(f"    {ms:10.1f} ms  {name[:90]}", flush=True)


def roll_permutation_p(y_true, y_pred, obs, offsets):
    """Plain version of ops/stats.permutation_pvalues: per offset k one
    float64 torch.roll of y_pred by k rows and its correlation with y_true;
    p = (1 + #{null >= obs}) times the float32 reciprocal of n + 1."""
    import torch

    yt = y_true.double() - y_true.double().mean(dim=0)
    yp = y_pred.double() - y_pred.double().mean(dim=0)
    den = torch.sqrt((yt * yt).sum(dim=0) * (yp * yp).sum(dim=0))
    o = obs.double()
    exceed = torch.zeros_like(o)
    for k in offsets.tolist():
        exceed += ((yt * torch.roll(yp, k, dims=0)).sum(dim=0) / den) >= o
    inv = torch.tensor(1.0 / (len(offsets) + 1.0), dtype=torch.float32)
    return (1.0 + exceed.float()) * inv.to(o.device)


def permutation_check(args, metrics, alphas):
    """(c)'s permutation p-values. Its first NS_ROLL_BLOCK voxels against
    roll_permutation_p on the same predictions (the first voxel chunk refit
    as _fit_and_score refits it, from (c)'s alphas), observed r and offsets
    (nested_cv._permutation_offsets, train/test mode): they must be equal.
    The NS_NULL noise-only voxels must not pile up at the 1/1001 floor: at
    most 2 there, at most 20% under 0.05, and a median p in [0.2, 0.8]."""
    import torch

    from litcoder_core_torch.models import nested_cv
    from litcoder_core_torch.models.ridge import (predict, ridge_fit_from_svd,
                                                  ridge_svd)
    from litcoder_core_torch.ops.stats import pearson_r
    from litcoder_core_torch.utils.device import matmul_tf32, to_numpy

    X_tr, Y_tr, X_te, Y_te = args
    with matmul_tf32(False):
        svd = ridge_svd(X_tr, None, singcutoff=1e-10, method="auto")
        nal = torch.as_tensor(alphas, dtype=torch.float32,
                              device=X_tr.device) * svd.S[0]
        pred = predict(X_te, ridge_fit_from_svd(svd, Y_tr[:, :NS_CHUNK],
                                                nal[:NS_CHUNK]))
    block = slice(0, NS_ROLL_BLOCK)
    obs = torch.as_tensor(np.asarray(metrics["correlations"][block],
                                     np.float32), device=X_tr.device)
    refit_gap = float(torch.max(torch.abs(
        pearson_r(Y_te[:, :NS_CHUNK], pred)[block] - obs)))
    offsets = nested_cv._permutation_offsets(0, None, NS_PERMUTATIONS,
                                             NS_TEST)
    p_roll = to_numpy(roll_permutation_p(Y_te[:, block], pred[:, block], obs,
                                         offsets)).astype(np.float64)
    p = np.asarray(metrics["p_values"])
    differ = int(np.sum(p_roll != p[block]))
    p_null = p[:NS_NULL]
    floor = float(np.float32(1.0 / (NS_PERMUTATIONS + 1)))
    at_floor = int(np.sum(p_null <= floor))
    under = float(np.mean(p_null < 0.05))
    median = float(np.median(p_null))
    print(f"  (c) roll null on voxels 0-{NS_ROLL_BLOCK - 1}: {differ} of "
          f"{NS_ROLL_BLOCK} p-values differ (refit |dr| {refit_gap:.3e}); "
          f"{NS_NULL} noise-only voxels: {at_floor} at the floor, "
          f"{under:.1%} under 0.05, median p {median:.4f}; signal voxels at "
          f"the floor {np.mean(p[NS_NULL:] <= floor):.4%}", flush=True)
    if differ or at_floor > 2 or under > 0.2 or not 0.2 <= median <= 0.8:
        raise AssertionError("(c): the permutation null is wrong")


class LogLines(logging.Handler):
    """Inside a with block, keeps the INFO lines of one port logger that
    contain `key`: the fast_scan='auto' guard's decision of a fit, the
    route of a nested_cv_step."""

    def __init__(self, logger_name, key):
        super().__init__(logging.INFO)
        self.log = logging.getLogger(logger_name)
        self.key = key
        self.messages = []

    def emit(self, record):
        if self.key in record.getMessage():
            self.messages.append(record.getMessage())

    def __enter__(self):
        self.saved_level = self.log.level
        self.log.addHandler(self)
        self.log.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.log.removeHandler(self)
        self.log.setLevel(self.saved_level)


def northstar_phase(smi_line):
    """benchmarks/northstar.py's whole-brain train/test fit, three ways.
    Returns (b)'s (metrics, alphas), which phase 16 (a) is held to."""
    import torch

    X, Y = signal_problem(NS_T + NS_TEST, NS_V, 1, n_null=NS_NULL)
    args = (X[:NS_T], Y[:NS_T], X[NS_T:], Y[NS_T:])
    print(f"  T={NS_T} train + {NS_TEST} test rows, D={NS_D}, V={NS_V} "
          f"({NS_NULL} of them noise only): Y {Y.numel() * 4 / 1e9:.2f} GB "
          f"on the card", flush=True)
    grid = np.logspace(-1, 8, 10)
    ma, aa = timed_fit("(a) voxel_chunk_size=4096", smi_line, *args,
                       voxel_chunk_size=NS_CHUNK)
    check_metrics(ma, NS_V, grid)
    mb, ab = timed_fit("(b) voxel_chunk_size=None", smi_line, *args)
    check_metrics(mb, NS_V, grid)
    agreement("(a) vs (b)", aa, ab, ma, mb, 0.999, 1e-4)
    with LogLines("litcoder_core_torch.models.nested_cv",
                  "fast_scan='auto'") as guard:
        mc, ac = timed_fit(f"(c) voxel_chunk_size=4096, fast_scan='auto', "
                           f"{NS_PERMUTATIONS} permutations", smi_line,
                           *args, voxel_chunk_size=NS_CHUNK,
                           fast_scan="auto", significance="permutation",
                           n_permutations=NS_PERMUTATIONS)
    for message in guard.messages:
        print(f"  (c) guard: {message}", flush=True)
    decision = mc["solver_paths"]["fast_scan"]
    if decision not in ("auto_accepted", "auto_rejected"):
        raise AssertionError(f"(c) recorded fast_scan {decision!r}")
    check_metrics(mc, NS_V, grid, _paths("chol", decision))
    if mc.get("significance_method") != "permutation":
        raise AssertionError("(c) lacks significance_method='permutation'")
    dm = agreement(f"(c, {decision}) vs (a)", ac, aa, mc, ma,
                   0.98 if decision == "auto_accepted" else 0.999, 1e-4)
    p = np.asarray(mc["p_values"])
    floor = float(np.float32(1.0 / (NS_PERMUTATIONS + 1)))
    print(f"  (c) permutation p: min {p.min():.6g} (floor {floor:.6g}), "
          f"n_significant {mc['n_significant']}", flush=True)
    if p.min() < floor or dm > 1e-3:
        raise AssertionError("(c): p under the floor or median r moved")
    permutation_check(args, mc, ac)
    profile_fit("(a)", smi_line, *args, voxel_chunk_size=NS_CHUNK)
    del X, Y, args
    torch.cuda.empty_cache()
    return mb, ab


def eigh_search_phase(smi_line):
    """The surface-width north-star problem through the Cholesky search and
    method='eigh': with chunks of 20 rows its 1,344 chunks split 269/268
    over the 5 folds, so 'eigh' takes the per-fold loop; with chunks of 21
    (1,280 chunks, 256 per fold) the folds are equal and partition the
    rows, so it takes the complement-gram eigh."""
    import torch

    X, Y = signal_problem(NS_T + NS_TEST, N_VERTICES, 2)
    args = (X[:NS_T], Y[:NS_T], X[NS_T:], Y[NS_T:])
    grid = np.logspace(-1, 8, 10)
    for chunk_length, search in ((20, "per_fold_loop_eigh"),
                                 (21, "complement_eigh")):
        mc, ac = timed_fit(f"chunks of {chunk_length}, method='auto'",
                           smi_line, *args, chunk_length=chunk_length)
        check_metrics(mc, N_VERTICES, grid)
        me, ae = timed_fit(f"chunks of {chunk_length}, method='eigh'",
                           smi_line, *args, chunk_length=chunk_length,
                           method="eigh")
        check_metrics(me, N_VERTICES, grid, _paths(search))
        dm = agreement(f"chunks of {chunk_length}, eigh vs auto", ae, ac, me,
                       mc, 0.999, 2e-3, where_same=False)
        if dm > 1e-3:
            raise AssertionError(f"median r moved by {dm}")
    del X, Y, args
    torch.cuda.empty_cache()


def bench_problem(seed):
    """bench.py's problem (bench._problem: X normal, W (D, V) / sqrt(D),
    Y = X W + unit noise, the held-out rows the same way) drawn on the card
    from a seeded torch.Generator: the distributions are bench.py's, the
    numbers are not its numpy draws."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((BENCH_T, BENCH_D), device=dev, generator=gen)
    W = torch.randn((BENCH_D, N_VERTICES), device=dev,
                    generator=gen) / BENCH_D ** 0.5
    Y = X @ W
    Y += torch.randn(Y.shape, device=dev, generator=gen)
    Xt = torch.randn((BENCH_TP, BENCH_D), device=dev, generator=gen)
    Yt = Xt @ W
    Yt += torch.randn(Yt.shape, device=dev, generator=gen)
    return X, Y, Xt, Yt


def step_flops(t_all, t_test, d, v, a, t_union, t_val, n_folds):
    """bench.flops_estimate with the problem's sizes as arguments: the
    Woodbury scan's and the union refit's products, factorizations and
    scoring. Matmul 2mnk, eigh 10 n^3, Cholesky n^3 / 3."""
    f = 2.0 * t_union * d * d + 2.0 * t_union * d * v + 10.0 * d ** 3
    per_fold = (2.0 * t_val * d * d + 2.0 * t_val * d * v
                + 2.0 * d * d * v + 24 * 4.0 * t_val * d
                + a * (2.0 * t_val * t_val * d + t_val ** 3 / 3.0 * 2.0
                       + 4.0 * t_val * t_val * d + 2.0 * t_val * d * v
                       + 6.0 * t_val * v))
    f += n_folds * per_fold
    k = t_all - t_union
    f += 2.0 * k * d * d + 2.0 * d * d * v + 4.0 * k * d * v + 2.0 * d * d * v
    f += 2.0 * t_test * d * v + 6.0 * t_test * v
    return f


def timed_step(label, smi_line, args, folds, grid, runs, **kw):
    """nested_cv_step on the card: one warm run (its route logged), then
    the median of `runs` synchronized walls and the peak device memory of
    those runs, the data included. Returns (alphas, metrics dict, wall)."""
    import torch

    from litcoder_core_torch.parallel.step import nested_cv_step

    def run():
        out = nested_cv_step(*args, grid, *folds, device="cuda", **kw)
        torch.cuda.synchronize()
        return out

    with LogLines(STEP_LOGGER, "nested_cv_step:") as log:
        run()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = run()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    corr, _, alphas, _ = check_step_result(label, out, args[1].shape[1],
                                           grid)
    wall = float(np.median(walls))
    metrics = {"correlations": corr, "median_score": float(np.median(corr))}
    print(f"  {label}: {log.messages[0]}; walls "
          f"{', '.join(f'{w:.4f}' for w in walls)} s (median {wall:.4f}), "
          f"median r {metrics['median_score']:.6f}, max_memory_allocated "
          f"{peak} bytes ({peak / 2**30:.2f} GiB), card: {smi_line}",
          flush=True)
    return alphas, metrics, wall


def stage_split(args, folds, grid, iters=3):
    """bench.stage_breakdown on the card: the scan stage alone, the scan at
    A=1, the union refit from the scan's union products (rebuilt untimed),
    prediction and scoring; each one warm call, then the median of `iters`
    synchronized calls. The alpha grid's share is (A - 1) marginal alphas
    scaled to A, the rest of the scan is fold-fixed."""
    import torch

    from litcoder_core_torch.parallel import step
    from litcoder_core_torch.utils.device import matmul_tf32

    dev = torch.device("cuda")
    X, Y, Xt, Yt = args
    alphas = torch.as_tensor(grid, device=dev)
    tr, va = (torch.as_tensor(f, dtype=torch.long, device=dev)
              for f in folds)
    kw = dict(normalpha=True, use_corr=True, single_alpha=False,
              singcutoff=1e-10, method="auto", complement=True,
              scan="woodbury", fast_scan=False)

    def timed(fn):
        out = fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls)), out

    scan_s, best = timed(lambda: step._scan_best_alphas(X, Y, alphas, tr, va,
                                                        **kw))
    scan_a1_s, _ = timed(lambda: step._scan_best_alphas(X, Y, alphas[:1], tr,
                                                        va, **kw))
    with matmul_tf32(False):
        union = torch.sort(va.reshape(-1)).values
        Xu = X[union]
        lam_u, Q = torch.linalg.eigh(Xu.T @ Xu)
        XtY_u = Xu.T @ Y[union]
    refit_s, weights = timed(lambda: step._refit_union_woodbury(
        X, Y, lam_u, Q, XtY_u, union, best, alphas, True))
    score_s, _ = timed(lambda: step._predict_and_score(Xt, Yt, weights))
    a_n = len(grid)
    grid_s = min(max(scan_s - scan_a1_s, 0.0) / max(a_n - 1, 1) * a_n, scan_s)
    stages = {"stage_scan_s": scan_s, "stage_scan_a1_s": scan_a1_s,
              "stage_refit_s": refit_s, "stage_predict_score_s": score_s,
              "scan_alpha_grid_s": grid_s,
              "scan_fold_fixed_s": scan_s - grid_s}
    print(f"  stage split (s): {json.dumps(stages)}", flush=True)


def bench_step_phase(smi_line):
    """bench.py's fused step on the card: Woodbury, Cholesky and eigh scans
    and the fast scan, their walls, agreement, stage split and TFLOP/s.
    Returns the 'auto' step's (alphas, metrics), which phase 16 (c) is
    held to."""
    import torch

    from litcoder_core_torch.parallel.step import equal_size_folds

    args = bench_problem(0)
    folds = equal_size_folds(BENCH_T, BENCH_F, BENCH_CHUNK, seed=0)
    grid = np.logspace(-1, 8, BENCH_A).astype(np.float32)
    t_val = folds[1].shape[1]
    t_union = folds[1].size
    print(f"  T={BENCH_T} TP={BENCH_TP} D={BENCH_D} V={N_VERTICES} "
          f"A={BENCH_A} F={BENCH_F}: Tva={t_val}, union {t_union} rows, "
          f"k={BENCH_T - t_union}", flush=True)
    runs = {}
    for label, kw in (("auto", {}), ("chol", dict(method="chol")),
                      ("eigh", dict(method="eigh")),
                      ("auto, fast_scan=True", dict(fast_scan=True))):
        runs[label] = timed_step(f"method {label}", smi_line, args, folds,
                                 grid, 3, **kw)
        if not runs[label][1]["median_score"] > BENCH_MEDIAN_R_FLOOR:
            raise AssertionError(f"{label}: median r under "
                                 f"{BENCH_MEDIAN_R_FLOOR}")
    for other in ("chol", "eigh"):
        agreement(f"{other} vs auto", runs[other][0], runs["auto"][0],
                  runs[other][1], runs["auto"][1], 0.999, 1e-4)
    fast = runs["auto, fast_scan=True"][0] == runs["auto"][0]
    print(f"  fast scan vs auto: same alpha on {fast.mean():.4%} of the "
          f"voxels (bench.py's alpha_agree)", flush=True)
    flops = step_flops(BENCH_T, BENCH_TP, BENCH_D, N_VERTICES, BENCH_A,
                       t_union, t_val, BENCH_F)
    for label in ("auto", "auto, fast_scan=True"):
        wall = runs[label][2]
        print(f"  {label}: {flops / 1e12:.3f} TFLOP (bench.flops_estimate) "
              f"in {wall:.4f} s = {flops / wall / 1e12:.2f} TFLOP/s, "
              f"{flops / wall / PEAK_F32_FLOP_PER_S:.1%} of the 67 TFLOP/s "
              f"fp32 peak", flush=True)
    stage_split(args, folds, grid)
    del args
    torch.cuda.empty_cache()
    return runs["auto"][:2]


def step_full_width_phase(smi_line):
    """The fused step at D=3072 on phase 9's generator: 'auto' (Woodbury
    scan at Tva=5360, union refit with k=80) against 'chol'."""
    import torch

    from litcoder_core_torch.parallel.step import equal_size_folds

    X, Y = signal_problem(NS_T + NS_TEST, N_VERTICES, 3)
    args = (X[:NS_T], Y[:NS_T], X[NS_T:], Y[NS_T:])
    folds = equal_size_folds(NS_T, 5, FUSED_CHUNK, seed=0)
    grid = np.logspace(-1, 8, 10).astype(np.float32)
    t_val, t_union = folds[1].shape[1], folds[1].size
    print(f"  T={NS_T} TP={NS_TEST} D={NS_D} V={N_VERTICES}: Tva={t_val}, "
          f"union {t_union} rows, k={NS_T - t_union}", flush=True)
    runs = {label: timed_step(f"method {label}", smi_line, args, folds, grid,
                              1, **kw)
            for label, kw in (("auto", {}), ("chol", dict(method="chol")))}
    for label, (_, metrics, _) in runs.items():
        if not metrics["median_score"] > FUSED_MEDIAN_R_FLOOR:
            raise AssertionError(f"{label}: median r under "
                                 f"{FUSED_MEDIAN_R_FLOOR}")
    agreement("chol vs auto", runs["chol"][0], runs["auto"][0],
              runs["chol"][1], runs["auto"][1], 0.999, 1e-4)
    flops = step_flops(NS_T, NS_TEST, NS_D, N_VERTICES, 10, t_union, t_val, 5)
    wall = runs["auto"][2]
    print(f"  auto: {flops / 1e12:.3f} TFLOP (bench.flops_estimate) in "
          f"{wall:.4f} s = {flops / wall / 1e12:.2f} TFLOP/s", flush=True)
    del X, Y, args
    torch.cuda.empty_cache()


def full_downsample_phase(asm, kv_path):
    """The ten methods on story 0 of the phase 5 assembly, its 768-wide
    word embeddings as the data."""
    from litcoder_core_torch import FeatureExtractorFactory

    emb = FeatureExtractorFactory.create_extractor(
        "embeddings", "random-static", {"vector_path": kv_path,
                                        "lowercase": False})
    data = FeatureExtractorFactory.extract_features_with_caching(
        emb, asm, asm.stories[0], 0)
    downsample_cases(f"LeBel story 0 ({data.shape[0]} words x "
                     f"{data.shape[1]})", data, asm.get_data_times()[0],
                     asm.get_tr_times()[0], asm.get_split_indices()[0], 1e-4,
                     timed=True)


def average_trainer_phase(asm, kv_path, workdir, smi_line):
    """The phase 5 trainer with the per-TR word average: the two-stage
    path (no kernel launch) into the same Cholesky search."""
    import torch

    from litcoder_core_torch.ops import lanczos_fir as lf

    trainer = make_trainer(asm, kv_path, "cuda",
                           os.path.join(workdir, "average_results"),
                           downsample_config={"method": "average"})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lf.launches = 0
    t0 = time.perf_counter()
    metrics = trainer.train(chunk_length=20, n_inner_folds=5)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check_metrics(metrics, N_VERTICES, np.logspace(-1, 8, 10))
    print(f"  lanczos_fir launches {lf.launches} (the two-stage path)",
          flush=True)
    report_path_run(metrics, wall, peak, smi_line, AVERAGE_MEDIAN_R_FLOOR)


# Phases 4 and 12: the language-model extractor. README section 3's
# extractor: GPT-2 at layer 9, last-token pooling, fullcontext windows of
# 256 words (each word is one HashStubTokenizer token, so a window holds up
# to 257 tokens with its BOS). GPT2Config() is GPT-2-small's published
# shape (12 layers, width 768, 12 heads, 1,024 positions, vocab 50,257);
# phase 4's model is 2 layers of width 16.
LM_LOOKBACK, LM_LAYER, LM_BATCH = 256, 9, 64
LM_STORIES = 12
GPT2_SMALL = dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                  n_head=12)
GPT2_TINY = dict(vocab_size=600, n_positions=1024, n_embd=16, n_layer=2,
                 n_head=2)
# Check (a): story 0's first 64 windows (one prefix chain) and 8 full-length
# windows from its middle, card against CPU under fixed weights, within
# 1e-3 of the CPU's largest magnitude (fp32 forwards with TF32 off, summed
# in another order over 12 layers); (b) the same windows with prefix sharing
# on and off on the card, within 1e-4. Phase 4's tiny model: 1e-5.
LM_CHECK_CHAIN, LM_CHECK_FULL = 64, 8
LM_CARD_CPU_RTOL, LM_PREFIX_RTOL, LM_SMALL_RTOL = 1e-3, 1e-4, 1e-5
# The JAX fit's route for 11 training stories of 305 rows at D = 768 x 4:
# each inner fold trains on about 2,684 rows < 3,072 features, so the fit
# takes the dual (kernel) search.
LM_PATHS = _paths("dual")


def stand_in_decoder(vocab_size, n_positions, n_embd, n_layer, n_head):
    """Built only when `transformers` is absent: a GPT-2-shaped decoder in
    plain torch (token and position embeddings, pre-LN blocks of causal
    attention and a GELU MLP, a final LN) with Hugging Face's call surface:
    model(input_ids=, attention_mask=, output_hidden_states=True) returns an
    object whose .hidden_states are the embeddings, each block's output and,
    in place of the last, the final LN of it, as GPT2Model's are; its
    .config has model_type 'gpt2', n_embd and n_layer."""
    import types

    import torch
    from torch import nn

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln_1 = nn.LayerNorm(n_embd)
            self.c_attn = nn.Linear(n_embd, 3 * n_embd)
            self.c_proj = nn.Linear(n_embd, n_embd)
            self.ln_2 = nn.LayerNorm(n_embd)
            self.c_fc = nn.Linear(n_embd, 4 * n_embd)
            self.mlp_proj = nn.Linear(4 * n_embd, n_embd)

        def forward(self, h, allowed):
            b, t, d = h.shape
            q, k, v = self.c_attn(self.ln_1(h)).split(d, dim=2)
            q, k, v = (x.view(b, t, n_head, d // n_head).transpose(1, 2)
                       for x in (q, k, v))
            scores = (q @ k.transpose(-1, -2)) / (d // n_head) ** 0.5
            scores = scores.masked_fill(~allowed[:, None],
                                        torch.finfo(scores.dtype).min)
            a = (scores.softmax(dim=-1) @ v).transpose(1, 2)
            h = h + self.c_proj(a.reshape(b, t, d))
            return h + self.mlp_proj(nn.functional.gelu(
                self.c_fc(self.ln_2(h)), approximate="tanh"))

    class Decoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.config = types.SimpleNamespace(
                model_type="gpt2", n_embd=n_embd, n_layer=n_layer)
            self.wte = nn.Embedding(vocab_size, n_embd)
            self.wpe = nn.Embedding(n_positions, n_embd)
            self.h = nn.ModuleList(Block() for _ in range(n_layer))
            self.ln_f = nn.LayerNorm(n_embd)
            for p in self.parameters():
                if p.dim() > 1:
                    nn.init.normal_(p, std=0.02)

        def forward(self, input_ids, attention_mask,
                    output_hidden_states=True):
            t = input_ids.shape[1]
            pos = torch.arange(t, device=input_ids.device)
            h = self.wte(input_ids) + self.wpe(pos)[None]
            causal = torch.ones(t, t, dtype=torch.bool,
                                device=input_ids.device).tril()
            allowed = causal[None] & attention_mask.bool()[:, None, :]
            hidden = [h]
            for block in self.h:
                h = block(h, allowed)
                hidden.append(h)
            hidden[-1] = self.ln_f(h)
            return types.SimpleNamespace(hidden_states=tuple(hidden))

    return Decoder()


def lm_model(shape):
    """(model on the CPU, description): GPT2Model(GPT2Config(**shape))
    initialised under torch.manual_seed(0), or the stand-in decoder of that
    shape when transformers is absent."""
    import torch

    torch.manual_seed(0)
    try:
        import transformers
    except ImportError:
        return (stand_in_decoder(**shape).eval(),
                "stand-in decoder (transformers absent)")
    from transformers import GPT2Config, GPT2Model

    return (GPT2Model(GPT2Config(**shape)).eval(),
            f"transformers {transformers.__version__} GPT2Model")


def fullcontext_windows(words, lookback=LM_LOOKBACK):
    """base_processor._process_fullcontext over HashStubTokenizer: the words
    max(0, i - lookback)..i, encoded, cut to their last `lookback` tokens
    and decoded; each word is one token, so the decode keeps the last
    `lookback` words."""
    from litcoder_core_torch.utils.testing import HashStubTokenizer

    tok = HashStubTokenizer()
    windows = []
    for i, w in enumerate(words):
        if w == "":
            windows.append("")
            continue
        text = " ".join(words[max(0, i - lookback):i + 1])
        n_tokens = len(tok.encode(text))
        if n_tokens > lookback:
            text = " ".join(text.split()[-lookback:])
        windows.append(text.strip())
    return windows


def lm_extractor(model, device, **config):
    """The port's extractor on an injected model (moved to `device`)."""
    from litcoder_core_torch.features.language_model import (
        LanguageModelFeatureExtractor,
    )
    from litcoder_core_torch.utils.testing import HashStubTokenizer

    return LanguageModelFeatureExtractor({
        "model_name": "gpt2-random-init", "model": model,
        "tokenizer": HashStubTokenizer(), "device": device,
        "batch_size": LM_BATCH, **config})


def compare_layers(label, got, want, rtol):
    """Every layer of `got` within rtol x max |want| of `want`; returns the
    worst ratio."""
    worst = 0.0
    for layer in want:
        scale = float(np.max(np.abs(want[layer])))
        err = float(np.max(np.abs(got[layer] - want[layer])))
        worst = max(worst, err / scale)
        if not err <= rtol * scale:
            raise AssertionError(f"{label}: layer {layer} differs by {err} "
                                 f"> {rtol} x {scale}")
    print(f"  {label}: {len(want)} layers, worst max |d| / max |ref| "
          f"{worst:.3e} (bar {rtol})", flush=True)
    return worst


def lm_trainer(assembly, extractor_model, device, workdir, label, layer,
               mesh=None):
    """(trainer, extractor): the LM extractor from the factory (on `mesh`
    when given: tensor-parallel), with its cache in workdir/<label>_cache,
    in the LeBel trainer."""
    from litcoder_core_torch import (
        AbstractTrainer,
        Downsampler,
        FeatureExtractorFactory,
        NestedCVModel,
    )
    from litcoder_core_torch.utils.testing import HashStubTokenizer

    ex = FeatureExtractorFactory.create_extractor(
        "language_model", "gpt2-random-init",
        {"model": extractor_model, "tokenizer": HashStubTokenizer(),
         "device": device, "batch_size": LM_BATCH, "last_token": True,
         "mesh": mesh},
        cache_dir=os.path.join(workdir, f"{label}_cache"))
    trainer = AbstractTrainer(
        assembly=assembly, feature_extractors=[ex],
        downsampler=Downsampler(),
        model=NestedCVModel(seed=0, device=device),
        fir_delays=[1, 2, 3, 4], trimming_config=dict(LEBEL_TRIM),
        use_train_test_split=True, layer_idx=layer, lookback=LM_LOOKBACK,
        dataset_type="lebel", logger_backend="none",
        results_dir=os.path.join(workdir, f"{label}_results"),
        downsample_config={"method": "lanczos", "window": 3,
                           "cutoff_mult": 1.0},
        device=device)
    return trainer, ex


def small_lm_phase(workdir):
    """A tiny GPT-2 through the port's extractor and trainer on three small
    stories, card against CPU: every layer's features, then the trainer's
    alphas and correlations. The responses carry a signal of the CPU's
    layer-1 features, Lanczos-downsampled and delayed."""
    import copy

    import torch

    from litcoder_core_torch import SimpleNeuroidAssembly, StoryData
    from litcoder_core_torch.ops import lanczos_fir as lf

    model, desc = lm_model(GPT2_TINY)
    card_model = copy.deepcopy(model).to("cuda")
    print(f"  model: {desc}, 2 layers of width 16", flush=True)
    rng = np.random.default_rng(6)
    n_tr, n_vox, delays = 100, 40, (1, 2, 3, 4)
    cpu_ex = lm_extractor(model, "cpu")
    card_ex = lm_extractor(card_model, "cuda")
    mix = (rng.standard_normal((4 * GPT2_TINY["n_embd"], n_vox))
           .astype(np.float32) / 8)
    stories = []
    for i in range(3):
        span = n_tr * TR_SECONDS
        n_words = int(span * WORDS_PER_S)
        data_times = np.sort(rng.uniform(0, span, n_words)).astype(
            np.float32)
        tr_times = (np.arange(n_tr) * TR_SECONDS + TR_SECONDS / 2).astype(
            np.float32)
        words = [f"w{k}" for k in rng.integers(0, 300, n_words)]
        windows = fullcontext_windows(words)
        want = cpu_ex.extract_all_layers(windows)
        compare_layers(f"story {i} ({n_words} windows), card vs CPU",
                       card_ex.extract_all_layers(windows), want,
                       LM_SMALL_RTOL)
        feats = lf.lanczos_fir_reference(
            torch.as_tensor(want[1]), torch.as_tensor(data_times),
            torch.as_tensor(tr_times), delays).numpy()
        signal = (feats / feats.std(0).clip(1e-6) @ mix)[10:n_tr - 5]
        brain = signal + rng.standard_normal(signal.shape).astype(np.float32)
        split = np.clip((data_times // TR_SECONDS).astype(int), 0, n_tr - 1)
        stories.append(StoryData(
            name=f"lm{i}", brain_data=brain.astype(np.float32),
            stimuli=windows, split_indices=split.tolist(), tr_times=tr_times,
            data_times=data_times, words=words,
            word_rates=np.bincount(split, minlength=n_tr).astype(np.float32)))
    asm = SimpleNeuroidAssembly(stories, validation_method="outer")
    models = {"cuda": card_model, "cpu": model}
    card_vs_cpu("LM trainer", lambda device: lm_trainer(
        asm, models[device], device, workdir, f"small_lm_{device}",
        layer=1)[0], EXPECTED_PATHS, dict(chunk_length=10, n_inner_folds=3))


def summed_stage_seconds(ex):
    """Wrap ex.extract_all_layers so that each call's last_stage_seconds
    adds into the returned dict."""
    totals = {}
    extract = ex.extract_all_layers

    def wrapped(*args, **kwargs):
        out = extract(*args, **kwargs)
        for key, value in ex.last_stage_seconds.items():
            totals[key] = totals.get(key, 0.0) + value
        return out

    ex.extract_all_layers = wrapped
    return totals


def lm_phase(asm, workdir, smi_line):
    """GPT-2-small-shaped random-init model through the port's LM extractor
    and trainer at full width on the first LM_STORIES stories of phase 5's
    assembly, their stimuli replaced by fullcontext windows: checks (a)-(e)
    and the extraction's counts and rates. Returns the kernel's launches in
    the first train(), the LM assembly, the first train()'s metrics and its
    windows/s (phase 16 (d) reuses all four and the activation cache)."""
    import copy
    import dataclasses

    import torch

    from litcoder_core_torch import SimpleNeuroidAssembly
    from litcoder_core_torch.ops import lanczos_fir as lf

    t0 = time.perf_counter()
    model, desc = lm_model(GPT2_SMALL)
    card_model = copy.deepcopy(model).to("cuda")
    print(f"  model: {desc}, GPT-2-small shape {json.dumps(GPT2_SMALL)}, "
          f"random init under torch.manual_seed(0), built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    stories = [dataclasses.replace(
        asm.story_data[name],
        stimuli=fullcontext_windows(asm.story_data[name].words))
        for name in asm.stories[:LM_STORIES]]
    lm_asm = SimpleNeuroidAssembly(stories, validation_method="outer")

    # (a) and (b) on story 0's first chain and 8 full windows.
    windows = stories[0].stimuli
    mid = len(windows) // 2
    check = windows[:LM_CHECK_CHAIN] + windows[mid:mid + LM_CHECK_FULL]
    t0 = time.perf_counter()
    cpu_feats = lm_extractor(model, "cpu").extract_all_layers(check)
    cpu_s = time.perf_counter() - t0
    card_feats = lm_extractor(card_model, "cuda").extract_all_layers(check)
    compare_layers(f"(a) {len(check)} windows, card vs CPU (CPU "
                   f"{cpu_s:.1f} s)", card_feats, cpu_feats,
                   LM_CARD_CPU_RTOL)
    del model
    flat = lm_extractor(card_model, "cuda", prefix_sharing=False)
    compare_layers("(b) prefix sharing on vs off, card",
                   card_feats, flat.extract_all_layers(check),
                   LM_PREFIX_RTOL)

    runs, rate = [], None
    for run in (1, 2):
        trainer, ex = lm_trainer(lm_asm, card_model, "cuda", workdir, "lm",
                                 LM_LAYER)
        stage = summed_stage_seconds(ex)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lf.launches = 0
        t0 = time.perf_counter()
        metrics = trainer.train(chunk_length=20, n_inner_folds=5)
        wall = time.perf_counter() - t0
        launches = lf.launches
        peak = torch.cuda.max_memory_allocated()
        counts = dict(ex.counts)
        runs.append((metrics, launches, counts))
        extract_s = stage.get("tokenize_s", 0.0) + stage.get(
            "forward_total_s", 0.0)
        print(f"  train() {run}: lanczos_fir launches {launches}; extractor "
              f"counts {json.dumps(counts)}; summed last_stage_seconds "
              f"{json.dumps({k: round(v, 4) for k, v in stage.items()})}",
              flush=True)
        if counts["windows"]:
            rate = counts["windows"] / extract_s
            print(f"  extraction: {counts['windows']} windows, "
                  f"{counts['real_tokens']} real and "
                  f"{counts['padded_tokens']} padded tokens in "
                  f"{counts['chain_forwards']} chain and "
                  f"{counts['single_forwards']} single forwards; "
                  f"{counts['windows'] / extract_s:.1f} windows/s, "
                  f"{counts['real_tokens'] / extract_s:.0f} real and "
                  f"{counts['padded_tokens'] / extract_s:.0f} padded "
                  f"tokens/s over tokenize + forward {extract_s:.3f} s",
                  flush=True)
        check_metrics(metrics, N_VERTICES, np.logspace(-1, 8, 10), LM_PATHS)
        # No floor: random-init features carry no planted signal.
        report_path_run(metrics, wall, peak, smi_line, None)
    (m1, launches, counts1), (m2, launches2, counts2) = runs
    if launches != LM_STORIES:
        raise AssertionError(f"(c) the kernel ran {launches} times, not "
                             f"{LM_STORIES}")
    if counts1["windows"] != sum(len(s.stimuli) for s in stories):
        raise AssertionError("the first train() did not extract every window")
    if counts2["windows"] or counts2["chain_forwards"] \
            or counts2["single_forwards"]:
        raise AssertionError(f"(e) the second train() ran forwards: {counts2}")
    dr = float(np.max(np.abs(np.asarray(m1["correlations"])
                             - np.asarray(m2["correlations"]))))
    same = m1["best_alphas"] == m2["best_alphas"]
    print(f"  (c) launches {launches} = {LM_STORIES} stories; (d) "
          f"solver_paths {m1['solver_paths']}; (e) second train(): "
          f"{launches2} launches, 0 forwards, same alphas {same}, max |dr| "
          f"{dr:.3e}", flush=True)
    if not same or dr > 1e-6:
        raise AssertionError("(e) the cached run's metrics differ")
    return launches, lm_asm, m1, rate


# Phases 4 and 13: README section 3 from AssemblyGenerator to the fit, with
# speech features. The extractor takes cli.py's speech defaults (windows of
# 16 s every 0.1 s, last-frame pooling, 16 kHz) and README section 4's
# model, facebook/wav2vec2-base-960h, as Wav2Vec2Model(Wav2Vec2Config()):
# its published width and depth (12 layers of 768, the group-norm feature
# encoder) with random weights under torch.manual_seed(0), and
# Wav2Vec2FeatureExtractor()'s defaults. One 21styear story of SPEECH_TR
# TRs of 1.5 s over 360 s of seeded audio (21styear runs 3,374 s), V=20484,
# layer 9, README section 4's wordrate extractor beside it, FIR delays 1-8
# (D = 8 x 768 + 8), trims 14:-9 and section 3's fit (NARR_FIT).
SPEECH_SUBJECT = "sub-256"
SPEECH_BOLD = (f"{SPEECH_SUBJECT}_task-21styear_space-MNI152NLin2009cAsym_"
               "res-2_desc-preproc_bold.nii.gz")
SPEECH_SR = 16000
SPEECH_CHUNK, SPEECH_CONTEXT, SPEECH_LAYER = 0.1, 16.0, 9
SPEECH_MODEL_NAME = "facebook/wav2vec2-base-960h"
# Check (a): the first SPEECH_CHECK_WINDOWS windows, card against CPU
# within 1e-3 of the CPU's largest magnitude on every layer (fp32 with TF32
# off for matmuls and convolutions, summed in another order over 12
# layers); phase 4's tiny encoder: 1e-5. The host preprocessing of
# SPEECH_PREP_WINDOWS windows is timed alone.
SPEECH_CHECK_WINDOWS, SPEECH_PREP_WINDOWS = 4, 64
SPEECH_CARD_CPU_RTOL, SPEECH_SMALL_RTOL = 1e-3, 1e-5
# Phase 4's tiny encoder (2 layers of width 24, a positional convolution of
# 12 taps in 2 groups), in each norm variant, over a data dir of 120 TRs
# (180 s of audio), windows of 1 s every 1 s, 40 voxels.
W2V2_TINY = dict(hidden_size=24, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=32, conv_dim=(8, 8), conv_kernel=(10, 3),
                 conv_stride=(5, 2), num_feat_extract_layers=2,
                 num_conv_pos_embeddings=12, num_conv_pos_embedding_groups=2)
SMALL_SPEECH = dict(n_tr=120, n_vox=40, chunk=1.0, context=1.0, layer=1)


class WhitespaceTokenizer:
    """One token per whitespace-separated word (encode splits, decode
    joins): the processors' injected tokenizer, where GPT-2's would be
    downloaded."""

    def encode(self, text, add_special_tokens=False):
        return text.split()

    def decode(self, tokens):
        return " ".join(tokens)


def write_narratives_dir(root, seed, n_tr, n_vox):
    """A Narratives data dir under root, from a seed: narratives_data.pkl
    with one 21styear story (words at about 2.5 words/s, their times and TR
    ids, n_tr TR times of 1.5 s from 0 s), 21styear.wav (n_tr x 1.5 s of
    16 kHz int16 audio) and sub-256/ holding an empty file with the BOLD
    NIfTI's BIDS name. The (n_tr, n_vox) responses, a planted signal of the
    word rate delayed by 1-8 TRs plus unit noise, go into the surface cache
    at root/surface_cache under that subject and file. Returns the data
    dir."""
    import pickle

    from scipy.io import wavfile

    from litcoder_core_torch.brain_projection import get_surface_cache

    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "narratives")
    subject_dir = os.path.join(data_dir, SPEECH_SUBJECT)
    os.makedirs(subject_dir)
    span = n_tr * SPEECH_TR_SECONDS
    n_words = int(span * WORDS_PER_S)
    data_times = np.sort(rng.uniform(0, span, n_words))
    split = np.clip((data_times // SPEECH_TR_SECONDS).astype(int), 0,
                    n_tr - 1)
    with open(os.path.join(data_dir, "narratives_data.pkl"), "wb") as f:
        pickle.dump([{
            "story_name": "21styear",
            "words": [f"w{k}" for k in rng.integers(0, VOCAB, n_words)],
            "data_times": data_times, "split_indices": split.tolist(),
            "tr_times": np.arange(n_tr) * SPEECH_TR_SECONDS,
        }], f)
    audio = 0.1 * 32767 * rng.standard_normal(int(span * SPEECH_SR))
    wavfile.write(os.path.join(data_dir, "21styear.wav"), SPEECH_SR,
                  audio.astype(np.int16))
    bold = os.path.join(subject_dir, SPEECH_BOLD)
    open(bold, "wb").close()
    rates = np.bincount(split, minlength=n_tr).astype(np.float64)
    delayed = np.stack([np.concatenate([np.zeros(d), rates[:-d]])
                        for d in NARR_DELAYS], axis=1)
    delayed = (delayed - delayed.mean(0)) / delayed.std(0)
    weights = (rng.standard_normal((len(NARR_DELAYS), n_vox))
               / np.sqrt(len(NARR_DELAYS)))
    brain = delayed @ weights + rng.standard_normal((n_tr, n_vox))
    get_surface_cache(os.path.join(root, "surface_cache")).set(
        SPEECH_SUBJECT, bold, brain.astype(np.float32))
    return data_dir


def narratives_speech_assembly(root, data_dir):
    """README section 3's first call on the port: the responses come from
    the surface cache seeded by write_narratives_dir."""
    from litcoder_core_torch.assembly import AssemblyGenerator
    from litcoder_core_torch.brain_projection import get_surface_cache

    get_surface_cache(os.path.join(root, "surface_cache"))
    return AssemblyGenerator.generate_assembly(
        "narratives", data_dir, subject=SPEECH_SUBJECT,
        tr=SPEECH_TR_SECONDS, lookback=256, tokenizer=WhitespaceTokenizer())


def speech_model(config):
    """(model on the CPU, feature extractor): Wav2Vec2Model of
    Wav2Vec2Config(**config) initialised under torch.manual_seed(0), and
    Wav2Vec2FeatureExtractor()."""
    import torch
    from transformers import (
        Wav2Vec2Config,
        Wav2Vec2FeatureExtractor,
        Wav2Vec2Model,
    )

    torch.manual_seed(0)
    return (Wav2Vec2Model(Wav2Vec2Config(**config)).eval(),
            Wav2Vec2FeatureExtractor())


def speech_extractor(model, fe, device, chunk, context, pool="last",
                     layer=SPEECH_LAYER, mesh=None):
    """The port's speech extractor on an injected model (moved to the card
    unless `device` is 'cpu'; tensor-parallel on `mesh` when given)."""
    from litcoder_core_torch.features.speech_model import (
        SpeechFeatureExtractor,
    )

    kw = {"device": "cpu"} if device == "cpu" else {}
    return SpeechFeatureExtractor(
        model_name=SPEECH_MODEL_NAME, chunk_size=chunk, context_size=context,
        layer=layer, pool=pool, model=model, feature_extractor=fe,
        mesh=mesh, **kw)


def speech_trainer(asm, model, fe, device, workdir, label, chunk, context,
                   layer):
    """(trainer, speech extractor): README section 4's wordrate and speech
    extractors from the factory (the speech cache in
    workdir/<label>_cache) in the Narratives trainer, full nested CV."""
    from litcoder_core_torch import (
        AbstractTrainer,
        Downsampler,
        FeatureExtractorFactory,
        NestedCVModel,
    )

    config = {"model": model, "feature_extractor": fe, "chunk_size": chunk,
              "context_size": context, "layer": layer, "pool": "last"}
    if device == "cpu":
        config["device"] = "cpu"
    speech = FeatureExtractorFactory.create_extractor(
        "speech", SPEECH_MODEL_NAME, config,
        cache_dir=os.path.join(workdir, f"{label}_cache"))
    wordrate = FeatureExtractorFactory.create_extractor("wordrate",
                                                        "wordrate", {})
    trainer = AbstractTrainer(
        assembly=asm, feature_extractors=[wordrate, speech],
        downsampler=Downsampler(), model=NestedCVModel(seed=0, device=device),
        fir_delays=list(NARR_DELAYS), trimming_config=dict(NARR_TRIM),
        use_train_test_split=False, layer_idx=layer, lookback=256,
        dataset_type="narratives", logger_backend="none",
        results_dir=os.path.join(workdir, f"{label}_results"),
        downsample_config={"method": "lanczos", "window": 3,
                           "cutoff_mult": 1.0},
        device=device)
    return trainer, speech


def small_speech_phase(workdir):
    """A tiny Wav2Vec2 through the port's speech extractor, card against
    CPU, in each norm variant and pool; then the Narratives trainer with
    wordrate and speech features on a tiny data dir, card against CPU."""
    import copy

    root = os.path.join(workdir, "small_speech")
    os.makedirs(root)
    cfg = SMALL_SPEECH
    data_dir = write_narratives_dir(root, 7, cfg["n_tr"], cfg["n_vox"])
    wav = os.path.join(data_dir, "21styear.wav")
    for norm in ("layer", "group"):
        model, fe = speech_model(dict(W2V2_TINY, feat_extract_norm=norm,
                                      do_stable_layer_norm=norm == "layer"))
        card_model = copy.deepcopy(model)
        for pool in ("last", "mean"):
            want, t_cpu = speech_extractor(
                model, fe, "cpu", cfg["chunk"], cfg["context"],
                pool).extract_all_layers(wav)
            got, t_card = speech_extractor(
                card_model, fe, "cuda", cfg["chunk"], cfg["context"],
                pool).extract_all_layers(wav)
            if not np.array_equal(t_card, t_cpu):
                raise AssertionError("card and CPU window times differ")
            compare_layers(f"tiny Wav2Vec2, feat_extract_norm={norm!r}, "
                           f"pool={pool!r}, {len(t_cpu)} windows, card vs "
                           "CPU", got, want, SPEECH_SMALL_RTOL)

    # The trainer runs the last pair: group norm, wav2vec2-base's variant.
    asm = narratives_speech_assembly(root, data_dir)
    models = {"cuda": card_model, "cpu": model}
    card_vs_cpu("speech Narratives trainer", lambda device: speech_trainer(
        asm, models[device], fe, device, root, f"small_{device}",
        cfg["chunk"], cfg["context"], cfg["layer"])[0],
        PER_FOLD_DUAL_PATHS, NARR_FIT)


def speech_phase(workdir, smi_line):
    """README section 3 from AssemblyGenerator to the fit with
    wav2vec2-base-shaped speech features on the card, at full width.

    The data dir is written from a seed (write_narratives_dir). Its
    responses are read from the surface cache, seeded here as a first run
    of the processor would have left it: the cache-hit path of
    NarrativesAssemblyGenerator._load_brain_data, the one a second run
    takes, which reads no NIfTI and needs no nibabel. Checks (a) the first
    windows card against CPU, (b) one kernel launch in train(), (c) finite
    metrics and the JAX fit's solver_paths, (d) a second train() on the
    same cache directory runs no forward and gives the same metrics bit for
    bit. Returns the kernel's launches in the first train() and the audio
    file (phase 16 (d) reads its first 30 s)."""
    import copy

    import torch
    import transformers
    from scipy.io import wavfile

    from litcoder_core_torch.features.speech_model import load_audio
    from litcoder_core_torch.ops import lanczos_fir as lf

    root = os.path.join(workdir, "speech")
    os.makedirs(root)
    t0 = time.perf_counter()
    data_dir = write_narratives_dir(root, zlib.crc32(b"narratives-speech"),
                                    SPEECH_TR, N_VERTICES)
    written = time.perf_counter() - t0
    t0 = time.perf_counter()
    asm = narratives_speech_assembly(root, data_dir)
    sd = asm.story_data["21styear"]
    print(f"  data dir: {SPEECH_TR} TRs of {SPEECH_TR_SECONDS} s, "
          f"{len(sd.words)} words, {SPEECH_TR * SPEECH_TR_SECONDS:.0f} s of "
          f"{SPEECH_SR} Hz audio, written in {written:.1f} s; assembly "
          f"(brain data {sd.brain_data.shape} from the surface cache, "
          f"{len(sd.stimuli)} fullcontext stimuli) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    model, fe = speech_model({})
    card_model = copy.deepcopy(model).to("cuda")
    cfg = model.config
    print(f"  model: transformers {transformers.__version__} "
          f"Wav2Vec2Model(Wav2Vec2Config()): {cfg.num_hidden_layers} layers "
          f"of {cfg.hidden_size}, feat_extract_norm "
          f"{cfg.feat_extract_norm!r}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, random "
          "init under torch.manual_seed(0)", flush=True)

    # (a) the first windows, card against CPU.
    audio = load_audio(sd.audio_path, SPEECH_SR)
    first = os.path.join(root, "first_windows.wav")
    n = (int(SPEECH_CONTEXT * SPEECH_SR)
         + (SPEECH_CHECK_WINDOWS - 1) * int(SPEECH_CHUNK * SPEECH_SR))
    wavfile.write(first, SPEECH_SR, audio[:n])
    t0 = time.perf_counter()
    want, t_cpu = speech_extractor(model, fe, "cpu", SPEECH_CHUNK,
                                   SPEECH_CONTEXT).extract_all_layers(first)
    cpu_s = time.perf_counter() - t0
    card_ex = speech_extractor(card_model, fe, "cuda", SPEECH_CHUNK,
                               SPEECH_CONTEXT)
    got, t_card = card_ex.extract_all_layers(first)
    if len(t_cpu) != SPEECH_CHECK_WINDOWS or not np.array_equal(t_card,
                                                                t_cpu):
        raise AssertionError(f"(a) window times {t_card} vs {t_cpu}")
    compare_layers(f"(a) first {SPEECH_CHECK_WINDOWS} windows, card vs CPU "
                   f"(CPU {cpu_s:.1f} s)", got, want, SPEECH_CARD_CPU_RTOL)
    del model

    windows, _ = card_ex._windows(audio)
    t0 = time.perf_counter()
    for lo in range(0, SPEECH_PREP_WINDOWS, card_ex.batch_size):
        card_ex._prepare_batch(windows[lo:lo + card_ex.batch_size])
    prep_s = time.perf_counter() - t0
    print(f"  host preprocessing alone: {SPEECH_PREP_WINDOWS} windows in "
          f"{prep_s:.4f} s (batches of {card_ex.batch_size}; "
          f"{prep_s / SPEECH_PREP_WINDOWS * windows.shape[0]:.2f} s for all "
          f"{windows.shape[0]} windows)", flush=True)

    runs = []
    for run in (1, 2):
        trainer, ex = speech_trainer(asm, card_model, fe, "cuda", root,
                                     "speech", SPEECH_CHUNK, SPEECH_CONTEXT,
                                     SPEECH_LAYER)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lf.launches = 0
        t0 = time.perf_counter()
        metrics = trainer.train(**NARR_FIT)
        wall = time.perf_counter() - t0
        launches = lf.launches
        peak = torch.cuda.max_memory_allocated()
        counts = dict(ex.counts)
        runs.append((metrics, launches, counts))
        print(f"  train() {run}: lanczos_fir launches {launches}; extractor "
              f"counts {json.dumps(counts)}", flush=True)
        if counts["windows"]:
            st = ex.last_stage_seconds
            print(f"  extraction: {counts['windows']} windows of "
                  f"{SPEECH_CONTEXT:.0f} s in {counts['forwards']} forwards;"
                  f" last_stage_seconds "
                  f"{json.dumps({k: round(v, 4) for k, v in st.items()})}; "
                  f"{counts['windows'] / st['forward_total_s']:.1f} windows/s"
                  f", {len(audio) / SPEECH_SR / st['forward_total_s']:.2f} "
                  "audio seconds per wall second", flush=True)
        check_metrics(metrics, N_VERTICES, np.logspace(-1, 8, 10),
                      PER_FOLD_DUAL_PATHS)
        # No floor: the speech features are random-init; the word-rate
        # signal sits in 8 of 6,152 columns.
        report_path_run(metrics, wall, peak, smi_line, None)
    (m1, launches, counts1), (m2, launches2, counts2) = runs
    if launches != 1:
        raise AssertionError(f"(b) the kernel ran {launches} times, not 1")
    if counts1["windows"] != SPEECH_FRAMES:
        raise AssertionError(f"{counts1['windows']} windows, not "
                             f"{SPEECH_FRAMES}")
    if counts2["windows"] or counts2["forwards"]:
        raise AssertionError(f"(d) the second train() ran forwards: "
                             f"{counts2}")
    dr = float(np.max(np.abs(np.asarray(m1["correlations"])
                             - np.asarray(m2["correlations"]))))
    same = (m1["best_alphas"] == m2["best_alphas"]
            and m1["correlations"] == m2["correlations"]
            and m1["median_score"] == m2["median_score"])
    print(f"  (b) launches {launches}; (c) solver_paths {m1['solver_paths']};"
          f" (d) second train(): {launches2} launches, 0 forwards, identical "
          f"alphas, correlations and median r {same} (max |dr| {dr:.3e})",
          flush=True)
    if not same:
        raise AssertionError("(d) the cached run's metrics differ")
    return launches, sd.audio_path


# Phases 4 and 14: banded ridge, stacking and variance partitioning.


def banded_problem(seed, T=240, dims=(24, 16), V=23, TP=40):
    """Seeded (Xs, Y, X_tests, y_test), numpy: Y = X1 W1 + 0.3 X2 W2 + 0.5
    noise (tests/test_torch_banded.py's generator)."""
    rng = np.random.default_rng(seed)
    ws = [rng.normal(size=(d, V)).astype(np.float32) / np.sqrt(d)
          for d in dims]
    scale = [1.0] + [0.3] * (len(dims) - 1)

    def draw(n):
        Xs = [rng.normal(size=(n, d)).astype(np.float32) for d in dims]
        Y = sum(c * X @ w for c, X, w in zip(scale, Xs, ws))
        return Xs, (Y + 0.5 * rng.normal(size=(n, V))).astype(np.float32)

    Xs, Y = draw(T)
    Xts, Yt = draw(TP)
    return Xs, Y, Xts, Yt


def two_space_problem(seed, T=300, Tp=80, dims=(20, 24), V=30):
    """Seeded two-space problem of tests/test_torch_stacking.py: the first
    space carries most of the signal."""
    rng = np.random.default_rng(seed)
    ws = [rng.normal(size=(d, V)).astype(np.float32) for d in dims]

    def draw(n):
        Xs = [rng.normal(size=(n, d)).astype(np.float32) for d in dims]
        Y = Xs[0] @ ws[0] + 0.5 * Xs[1] @ ws[1]
        return Xs, (Y + 3.0 * rng.normal(size=(n, V))).astype(np.float32)

    Xs, Y = draw(T)
    Xts, Yt = draw(Tp)
    return Xs, Y, Xts, Yt


def max_gap(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def banded_cases_phase():
    """fit_banded_ridge on the card and on the CPU through every scan route,
    fit_stacked_ridge on both refit routes, chunked and not, and
    variance_partitioning with 2 spaces."""
    import torch

    from litcoder_core_torch.models import (
        fit_banded_ridge,
        fit_stacked_ridge,
        variance_partitioning,
    )

    problems = {"tall": banded_problem(17),
                "tall80": banded_problem(18, V=80),
                "wide": banded_problem(21, T=120, dims=(100, 80)),
                "square": banded_problem(23, dims=(100, 80))}
    for label, name, on_device, kw, paths in BANDED_CASES:
        Xs, Y, Xts, Yt = problems[name]
        got = {}
        for device in ("cuda", "cpu"):
            Y_in = torch.as_tensor(Y, device=device) if on_device else Y
            got[device] = fit_banded_ridge(Xs, Y_in, Xts, Yt, device=device,
                                           **BANDED_FIT, **kw)
            if got[device][0]["solver_paths"] != paths:
                raise AssertionError(
                    f"banded {label}, {device}: solver_paths "
                    f"{got[device][0]['solver_paths']}, expected {paths}")
        (mg, wg, ag, gg), (mc, wc, ac, gc) = got["cuda"], got["cpu"]
        same = bool(np.array_equal(ag, ac) and np.array_equal(gg, gc))
        dr = max_gap(mg["correlations"], mc["correlations"])
        dw = max_gap(wg, wc) / float(np.max(np.abs(wc)))
        line = (f"  banded {label}: {paths['banded_scan']}/"
                f"{paths['banded_refit']} on both, same alphas and gammas "
                f"{same}, max |dr| {dr:.3e} (bar {BANDED_ATOL}), max |dw| / "
                f"max |w| {dw:.3e}, stages {sorted(mg['stage_seconds'])}")
        if "significance" in kw:
            same_p = mg["p_values"] == mc["p_values"]
            line += f", identical permutation p-values {same_p}"
            if not same_p:
                raise AssertionError("banded permutation p-values differ")
        print(line, flush=True)
        if not same or dr > BANDED_ATOL:
            raise AssertionError(f"banded {label}: card and CPU disagree")

    problem = two_space_problem(3)
    for label, kw, oof in STACK_CASES:
        got = {device: fit_stacked_ridge(*problem, device=device,
                                         **STACK_FIT, **kw)
               for device in ("cuda", "cpu")}
        (mg, wg, ag), (mc, wc, ac) = got["cuda"], got["cpu"]
        for device, (m, _, _) in got.items():
            if m["solver_paths"]["oof_refit"] != oof:
                raise AssertionError(f"stacking {label}, {device}: "
                                     f"{m['solver_paths']}")
        dr = max_gap(mg["correlations"], mc["correlations"])
        dw = max_gap(wg, wc)
        print(f"  stacking {label}: {mg['solver_paths']} on both, same "
              f"alphas {bool(np.array_equal(ag, ac))}, max |dr| {dr:.3e} "
              f"(bar {BANDED_ATOL}), max |d stack weight| {dw:.3e} (bar "
              f"{STACK_W_ATOL})", flush=True)
        if (not np.array_equal(ag, ac) or dr > BANDED_ATOL
                or dw > STACK_W_ATOL or mg["solver_paths"]
                != mc["solver_paths"]):
            raise AssertionError(f"stacking {label}: card and CPU disagree")

    Xs, Y, Xts, Yt = problem
    got = {device: variance_partitioning(Xs, Y, Xts, Yt, device=device,
                                         **STACK_FIT)
           for device in ("cuda", "cpu")}
    gpu, cpu = got["cuda"], got["cpu"]
    gap = max(max_gap(gpu[k], cpu[k]) for k in cpu)
    print(f"  variance_partitioning, 2 spaces: keys {sorted(gpu)}, max "
          f"|d component| {gap:.3e} (bar {VP_ATOL})", flush=True)
    if sorted(gpu) != sorted(cpu) or gap > VP_ATOL:
        raise AssertionError("variance partitioning: card and CPU disagree")


class Recorded:
    """A model whose fit_predict keeps its arguments and its result (the
    trainer returns only the metrics)."""

    def __init__(self, model):
        self.model = model
        self.args = self.kwargs = self.out = None

    def fit_predict(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs
        self.out = self.model.fit_predict(*args, **kwargs)
        return self.out


def spaces_trainer(asm, kv_path, model, results_dir):
    """README section 4's --banded trainer on the card: the word rate and
    the static embeddings as two feature spaces (concat_features=False),
    the fused Lanczos+FIR stage with delays 1-4, LeBel trimming."""
    from litcoder_core_torch import (
        AbstractTrainer,
        Downsampler,
        FeatureExtractorFactory,
    )

    return AbstractTrainer(
        assembly=asm,
        feature_extractors=[
            FeatureExtractorFactory.create_extractor("wordrate", "wordrate",
                                                     {}),
            FeatureExtractorFactory.create_extractor(
                "embeddings", "random-static",
                {"vector_path": kv_path, "lowercase": False}),
        ],
        downsampler=Downsampler(), model=model, fir_delays=[1, 2, 3, 4],
        trimming_config=dict(LEBEL_TRIM), use_train_test_split=True,
        dataset_type="lebel", logger_backend="none", results_dir=results_dir,
        downsample_config={"method": "lanczos", "window": 3,
                           "cutoff_mult": 1.0},
        concat_features=False, device="cuda")


def check_spaces_metrics(label, metrics, n_vox, paths):
    """Finite correlations and p-values of the right shape, alphas from
    the grid, the expected solver_paths."""
    corr = np.asarray(metrics["correlations"])
    p = np.asarray(metrics["p_values"])
    if corr.shape != (n_vox,) or not np.all(np.isfinite(corr)):
        raise AssertionError(f"{label}: correlations {corr.shape}")
    if not (np.all(np.isfinite(p)) and np.all((p >= 0) & (p <= 1))):
        raise AssertionError(f"{label}: p-values not finite in [0, 1]")
    grid = np.logspace(-1, 8, 10).astype(np.float32)
    if not np.all(np.isin(np.asarray(metrics["best_alphas"], np.float32),
                          grid)):
        raise AssertionError(f"{label}: alphas outside the grid")
    if metrics["solver_paths"] != paths:
        raise AssertionError(f"{label}: solver_paths "
                             f"{metrics['solver_paths']}, expected {paths}")


def spaces_trainer_run(label, asm, kv_path, model, workdir, smi_line, paths):
    """train() of spaces_trainer on the card: kernel launches, the model's
    stage split and the trainer's, peak memory, median r (above
    MEDIAN_R_FLOOR), the expected route. Returns (metrics, launches,
    the recorded model)."""
    import torch

    from litcoder_core_torch.ops import lanczos_fir as lf

    rec = Recorded(model)
    trainer = spaces_trainer(asm, kv_path, rec,
                             os.path.join(workdir, f"{label}_results"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lf.launches = 0
    t0 = time.perf_counter()
    metrics = trainer.train(chunk_length=20, n_inner_folds=5)
    wall = time.perf_counter() - t0
    launches = lf.launches
    peak = torch.cuda.max_memory_allocated()
    check_spaces_metrics(label, metrics, N_VERTICES, paths)
    print(f"  ({label}) lanczos_fir launches {launches}; the model's "
          f"stage_seconds {json.dumps(metrics['stage_seconds'])}", flush=True)
    report_path_run(metrics, wall, peak, smi_line, MEDIAN_R_FLOOR)
    if launches != N_STORIES:
        raise AssertionError(f"({label}) the kernel ran {launches} times, not "
                             f"{N_STORIES}")
    return metrics, launches, rec


def banded_scan_problem(seed):
    """phase 14 (d)'s problem, drawn on the card from a seed: (Xs, Y,
    X_tests, y_test) as card tensors."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    Xs = [randn(BSCAN_T, d) for d in BSCAN_BANDS]
    Xts = [randn(BSCAN_TP, d) for d in BSCAN_BANDS]
    ws = [randn(d, BSCAN_RANK) / d ** 0.5 for d in BSCAN_BANDS]
    mix = randn(BSCAN_RANK, N_VERTICES) / 12.0
    Y = sum(X @ w for X, w in zip(Xs, ws)) @ mix
    Y += randn(BSCAN_T, N_VERTICES)
    Yt = sum(X @ w for X, w in zip(Xts, ws)) @ mix
    Yt += randn(BSCAN_TP, N_VERTICES)
    return Xs, Y, Xts, Yt


def timed_banded(label, smi_line, Xs, Y, Xts, Yt, **kw):
    """fit_banded_ridge on the card at phase 14 (d)'s arguments: wall
    (synchronized), stage split, peak memory (data included), median r,
    route."""
    import torch

    from litcoder_core_torch.models import fit_banded_ridge

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m, w, alphas, gammas = fit_banded_ridge(
        Xs, Y, Xts, Yt, alphas=np.logspace(-1, 8, 10), n_gammas=BSCAN_GAMMAS,
        n_inner_folds=5, chunk_length=FUSED_CHUNK, seed=0,
        return_weights=False, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if w is not None:
        raise AssertionError("return_weights=False returned weights")
    check_spaces_metrics(label, m, N_VERTICES, CHOL_BANDED)
    print(f"  {label}: fit wall {wall:.3f} s, stage_seconds "
          f"{json.dumps(m['stage_seconds'])}, median r "
          f"{m['median_score']:.6f} (floor {BSCAN_MEDIAN_R_FLOOR}), "
          f"n_significant {m['n_significant']}, solver_paths "
          f"{m['solver_paths']}, max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB), card: {smi_line}", flush=True)
    if not m["median_score"] > BSCAN_MEDIAN_R_FLOOR:
        raise AssertionError(f"{label}: median r {m['median_score']}")
    return m, alphas, gammas


def banded_phase(asm, kv_path, workdir, smi_line):
    """README section 4's --banded fit at full width: (a) the banded
    trainer, (b) the stacked one, (c) variance partitioning of (a)'s
    spaces, (d) fit_banded_ridge at benchmarks/banded_scan.py's surface
    problem, device-resident and host-streamed. Returns (a)'s launches
    ((b) must launch as many) and (a)'s and (b)'s metrics."""
    import torch

    from litcoder_core_torch.models import (
        BandedRidgeModel,
        StackedRidgeModel,
        variance_partitioning,
    )

    # (a) banded ridge through the trainer.
    m_a, launches, rec_a = spaces_trainer_run(
        "a", asm, kv_path,
        BandedRidgeModel(seed=0, n_gammas=BANDED_N_GAMMAS, device="cuda"),
        workdir, smi_line, CHOL_BANDED)
    gammas = rec_a.out[3]
    if gammas.shape != (N_VERTICES, 2) or np.asarray(
            m_a["best_gammas"]).shape != (N_VERTICES, 2):
        raise AssertionError(f"(a) best_gammas {gammas.shape}")
    widths = [X.shape[1] for X in rec_a.args[0]]
    print(f"  (a) spaces {widths} (D = {sum(widths)}), {len(rec_a.args[1])} "
          f"training rows; median gamma of the embeddings "
          f"{float(np.median(gammas[:, 1])):.4f}", flush=True)

    # (b) stacked regression through the same trainer.
    m_b, _, rec_b = spaces_trainer_run(
        "b", asm, kv_path, StackedRidgeModel(seed=0, device="cuda"), workdir,
        smi_line, STACKED_PATHS)
    w = rec_b.out[1]
    row_gap = float(np.max(np.abs(w.sum(axis=1) - 1.0)))
    print(f"  (b) stack weights {w.shape}: min {float(w.min()):.3e}, max "
          f"|row sum - 1| {row_gap:.3e} (bar {STACK_SIMPLEX_ATOL}); blend "
          f"median r {m_b['median_score']:.6f}, each space alone "
          f"{[round(float(np.median(r)), 6) for r in m_b['per_space_test_r']]}"
          f", stack_weights_mean {m_b['stack_weights_mean']}", flush=True)
    if w.shape != (N_VERTICES, 2) or w.min() < 0 \
            or row_gap > STACK_SIMPLEX_ATOL:
        raise AssertionError("(b) stack weights off the simplex")
    del rec_b

    # (c) variance partitioning of (a)'s structured spaces.
    Xs, Y = rec_a.args
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vp = variance_partitioning(Xs, Y, rec_a.kwargs["X_tests"],
                               rec_a.kwargs["y_test"], device="cuda",
                               chunk_length=20, n_inner_folds=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ident = float(np.max(np.abs(vp["r2_AB"] - vp["unique_A"]
                                - vp["unique_B"] - vp["shared"])))
    finite = all(np.all(np.isfinite(v)) and v.shape == (N_VERTICES,)
                 for v in vp.values())
    print(f"  (c) variance_partitioning (A word rate, B embeddings): "
          f"{wall:.3f} s for 3 fits; medians "
          f"{ {k: round(float(np.median(v)), 6) for k, v in vp.items()} }; "
          f"max |r2_AB - unique_A - unique_B - shared| {ident:.3e} (bar "
          f"{VP_IDENTITY_ATOL}); all finite {finite}", flush=True)
    if not finite or ident > VP_IDENTITY_ATOL:
        raise AssertionError("(c) variance partitioning")
    del rec_a, Xs, Y, vp

    # (d) benchmarks/banded_scan.py's surface problem, two ways.
    Xs, Y, Xts, Yt = banded_scan_problem(5)
    print(f"  (d) T={BSCAN_T}, bands {list(BSCAN_BANDS)}, V={N_VERTICES}, "
          f"{BSCAN_TP} test rows, n_gammas {BSCAN_GAMMAS}", flush=True)
    m1, a1, g1 = timed_banded("(d) response on the card, no voxel chunks",
                              smi_line, Xs, Y, Xts, Yt)
    Y_host = Y.cpu().numpy()
    del Y
    m2, a2, g2 = timed_banded(
        f"(d) host response streamed, voxel chunks of {BSCAN_CHUNK}",
        smi_line, Xs, Y_host, Xts, Yt, voxel_chunk_size=BSCAN_CHUNK)
    if "xty_stream" not in m2["stage_seconds"]:
        raise AssertionError("(d) the host response did not stream")
    same = (a1 == a2) & np.all(g1 == g2, axis=1)
    gap = np.abs(np.asarray(m1["correlations"])
                 - np.asarray(m2["correlations"]))
    dr = float(np.max(gap[same], initial=0.0))
    print(f"  (d) same (gamma, alpha) on {int(same.sum())} of {same.size} "
          f"voxels ({same.mean():.4%}), max |dr| {dr:.3e} where they agree",
          flush=True)
    if same.mean() < 0.999 or dr > 1e-4:
        raise AssertionError("(d) device-resident and host-streamed fits "
                             "disagree")
    return launches, m_a, m_b


@contextlib.contextmanager
def wrapped(owner, name, make):
    """owner.<name> replaced by make(original) inside the block (a method
    of a class, or a module's function); the original is put back."""
    original = owner.__dict__[name]
    setattr(owner, name, make(getattr(owner, name)))
    try:
        yield
    finally:
        setattr(owner, name, original)


def cli_argv(asm_path, workdir, label, *extra):
    """The LeBel command line a user would type, with the cache and results
    in workdir/<label>_cache and _results."""
    return ["--dataset_type", "lebel", "--assembly_path", asm_path,
            "--ndelays", "4", "--lookback", str(LM_LOOKBACK),
            "--cache_dir", os.path.join(workdir, f"{label}_cache"),
            "--results_dir", os.path.join(workdir, f"{label}_results"),
            "--logger_backend", "none", *extra]


def small_cli_phase(workdir):
    """cli.run on a small LeBel pickle, card against CPU (word rate;
    --banded and --stacking with the embeddings), then
    LinearPredictivityModel on a small seeded problem."""
    from litcoder_core_torch import cli, save_assembly
    from litcoder_core_torch.models import LinearPredictivityModel

    kv_path = os.path.join(workdir, "small_cli.kv")
    asm, _ = build_assembly(4, 4, 120, 6, 40, 400, kv_path, 1.0)
    asm_path = os.path.join(workdir, "small_cli.pkl")
    save_assembly(asm, asm_path)
    for label, flags in SMALL_CLI_CASES:
        got = {}
        for device in ("cuda", "cpu"):
            argv = cli_argv(asm_path, workdir, f"cli_{device}", *flags,
                            "--vector_path", kv_path, "--chunk_length",
                            "10", "--n_inner_folds", "3", "--device", device)
            got[device] = cli.run(vars(cli.parse_args(argv)))
        gpu, cpu = got["cuda"], got["cpu"]
        same = (gpu["best_alphas"] == cpu["best_alphas"]
                and gpu.get("best_gammas") == cpu.get("best_gammas"))
        dr = max_gap(gpu["correlations"], cpu["correlations"])
        line = (f"  cli.run {label}: solver_paths {gpu['solver_paths']}, "
                f"same alphas and gammas {same}, max |dr| {dr:.3e} (bar "
                f"{BANDED_ATOL})")
        dw = 0.0
        if "stack_weights_mean" in cpu:
            dw = max_gap(gpu["stack_weights_mean"], cpu["stack_weights_mean"])
            line += (f", max |d mean stack weight| {dw:.3e} (bar "
                     f"{STACK_W_ATOL})")
        print(line, flush=True)
        if (not same or dr > BANDED_ATOL or dw > STACK_W_ATOL
                or gpu["solver_paths"] != cpu["solver_paths"]):
            raise AssertionError(f"cli.run {label}: card and CPU disagree")

    rng = np.random.default_rng(21)
    X = rng.standard_normal((SMALL_LINEAR_T, SMALL_LINEAR_D),
                            dtype=np.float32)
    W = rng.standard_normal((SMALL_LINEAR_D, 40), dtype=np.float32)
    Y = X @ W + 2.0 * rng.standard_normal((SMALL_LINEAR_T, 40),
                                          dtype=np.float32)
    groups = np.repeat(np.arange(SMALL_LINEAR_GROUPS),
                       SMALL_LINEAR_T // SMALL_LINEAR_GROUPS)
    models, got = {}, {}
    for device in ("cuda", "cpu"):
        models[device] = LinearPredictivityModel(
            {"n_folds": SMALL_LINEAR_GROUPS, "device": device})
        got[device] = models[device].fit(X, Y, groups=groups)
    dr = max_gap(got["cuda"]["correlations"], got["cpu"]["correlations"])
    dc = max(max_gap(g[0], c[0]) / float(np.max(np.abs(c[0])))
             for g, c in zip(models["cuda"].models, models["cpu"].models))
    print(f"  LinearPredictivityModel ({SMALL_LINEAR_T}, {SMALL_LINEAR_D}), "
          f"{SMALL_LINEAR_GROUPS} groups: median r "
          f"{got['cuda']['median_score']:.6f}, max |dr| {dr:.3e} (bar "
          f"{BANDED_ATOL}), max |d coef| / max |coef| {dc:.3e} (bar "
          f"{LINEAR_COEF_RTOL})", flush=True)
    if dr > BANDED_ATOL or dc > LINEAR_COEF_RTOL:
        raise AssertionError("LinearPredictivityModel: card and CPU disagree")


def saved_pickle(asm, path):
    """save_assembly to `path`; prints the write and a timed load_assembly
    (what cli.run pays first)."""
    from litcoder_core_torch import load_assembly, save_assembly

    t0 = time.perf_counter()
    save_assembly(asm, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_assembly(path)
    load_s = time.perf_counter() - t0
    print(f"  {os.path.basename(path)}: {len(asm.stories)} stories, "
          f"{os.path.getsize(path)} bytes, save_assembly {save_s:.3f} s, "
          f"load_assembly {load_s:.3f} s", flush=True)
    return path


def timed_main(label, argv, smi_line):
    """cli.main(argv) on the card, which must launch the kernel once per
    story: (metrics, launches); prints the wall, the stage split and the
    peak."""
    import torch

    from litcoder_core_torch import cli
    from litcoder_core_torch.ops import lanczos_fir as lf

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lf.launches = 0
    t0 = time.perf_counter()
    metrics = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = lf.launches
    peak = torch.cuda.max_memory_allocated()
    stages = metrics["trainer_stage_seconds"]
    print(f"  {label}: cli.main wall {wall:.3f} s (outside train(): "
          f"{wall - sum(stages.values()):.3f} s, the pickle's load and the "
          f"wiring); trainer_stage_seconds {json.dumps(stages)}; "
          f"lanczos_fir launches {launches}; median r "
          f"{metrics['median_score']:.6f}; solver_paths "
          f"{metrics['solver_paths']}; max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB), card: {smi_line}", flush=True)
    if launches != N_STORIES:
        raise AssertionError(f"{label}: the kernel ran {launches} times, not "
                             f"{N_STORIES}")
    return metrics, launches


def same_fit(label, got, want, keys=("best_alphas",)):
    """The same picks and median r within CLI_SAME_R_ATOL as `want`."""
    dm = abs(got["median_score"] - want["median_score"])
    same = all(got[k] == want[k] for k in keys)
    print(f"  {label}: same {', '.join(keys)} {same}, |d median r| "
          f"{dm:.3e} (bar {CLI_SAME_R_ATOL}), solver_paths equal "
          f"{got['solver_paths'] == want['solver_paths']}", flush=True)
    if not same or dm > CLI_SAME_R_ATOL \
            or got["solver_paths"] != want["solver_paths"]:
        raise AssertionError(f"{label}: the fits differ")


def cli_layer_sweep(lm_asm, workdir, smi_line):
    """(c): sweeps.run_grid_sweep over CLI_LAYERS of phase 12's assembly,
    its GPT-2-small-shaped model injected and its activation cache reused;
    a second call must resume from its checkpoints."""
    import glob

    import torch

    from litcoder_core_torch import cli, sweeps
    from litcoder_core_torch.features.factory import FeatureExtractorFactory
    from litcoder_core_torch.ops import lanczos_fir as lf
    from litcoder_core_torch.utils.testing import HashStubTokenizer

    lm_path = saved_pickle(lm_asm, os.path.join(workdir, "lm12.pkl"))
    model, desc = lm_model(GPT2_SMALL)
    base = vars(cli.parse_args([
        "--dataset_type", "lebel", "--assembly_path", lm_path,
        "--modalities", "language_model", "--model_names",
        "gpt2-random-init", "--last_token", "--ndelays", "4",
        "--lookback", str(LM_LOOKBACK), "--cache_dir",
        os.path.join(workdir, "lm_cache"), "--results_dir",
        os.path.join(workdir, "sweep_results"), "--logger_backend", "none"]))
    base["extractor_config_overrides"] = {"language_model": {
        "model": model.to("cuda"), "tokenizer": HashStubTokenizer(),
        "batch_size": LM_BATCH}}
    kw = dict(checkpoint_dir=os.path.join(workdir, "sweep_ckpt"),
              summary_path=os.path.join(workdir, "sweep_summary.json"),
              layer_idx=CLI_LAYERS)
    extractors, walls = [], []

    def record_extractor(create):
        def create_and_keep(*args, **kwargs):
            extractors.append(create(*args, **kwargs))
            return extractors[-1]
        return create_and_keep

    def timed_run(run):
        def run_and_time(config):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = run(config)
            walls.append((config["layer_idx"], time.perf_counter() - t0,
                          metrics["trainer_stage_seconds"]))
            return metrics
        return run_and_time

    lf.launches = 0
    with wrapped(FeatureExtractorFactory, "create_extractor",
                 record_extractor), wrapped(cli, "run", timed_run):
        t0 = time.perf_counter()
        rows = sweeps.run_grid_sweep(base, **kw)
        wall = time.perf_counter() - t0
        launches = lf.launches
        runs = sorted(glob.glob(os.path.join(workdir, "sweep_results",
                                             "run_*")))
        t0 = time.perf_counter()
        again = sweeps.run_grid_sweep(base, **kw)
        wall_again = time.perf_counter() - t0
    print(f"  (c) model: {desc}; grid of {len(rows)} layers in {wall:.3f} s, "
          f"lanczos_fir launches {launches}", flush=True)
    for layer, seconds, stages in walls:
        print(f"  (c) layer {layer}: cli.run {seconds:.3f} s, "
              f"trainer_stage_seconds {json.dumps(stages)}", flush=True)
    for ex in extractors:
        print(f"  (c) extractor counts {json.dumps(ex.counts)}", flush=True)
    for line in sweeps.summarize_sweep(rows).splitlines():
        print(f"  (c) {line}", flush=True)
    runs_again = sorted(glob.glob(os.path.join(workdir, "sweep_results",
                                               "run_*")))
    print(f"  (c) second call: {wall_again:.3f} s, {len(walls)} cli.run "
          f"calls in all, {len(runs_again)} run directories (first call "
          f"{len(runs)}), the same rows {again == rows}", flush=True)
    forwards = sum(ex.counts["windows"] for ex in extractors)
    if (any(r["error"] is not None for r in rows)
            or [r["layer_idx"] for r in rows] != CLI_LAYERS):
        raise AssertionError(f"(c) sweep rows {rows}")
    if forwards or len(extractors) != len(CLI_LAYERS):
        raise AssertionError(f"(c) {forwards} windows extracted by "
                             f"{len(extractors)} extractors: the activation "
                             "cache was missed")
    if launches != len(CLI_LAYERS) * LM_STORIES:
        raise AssertionError(f"(c) the kernel ran {launches} times")
    if again != rows or runs_again != runs or len(walls) != len(CLI_LAYERS):
        raise AssertionError("(c) the second sweep did not resume")


def linear_full_width(smi_line):
    """(d): LinearPredictivityModel.fit at phase 9's generator's full
    width, the first fold's coefficients against a float64 solve."""
    import torch

    from litcoder_core_torch.models import LinearPredictivityModel, linear
    from litcoder_core_torch.models.folding import group_kfold_splits

    X, Y = signal_problem(LINEAR_T, N_VERTICES, 9)
    groups = np.arange(LINEAR_T) // LINEAR_GROUP_ROWS
    model = LinearPredictivityModel({"n_folds": LINEAR_FOLDS,
                                     "device": "cuda"})
    solves = []

    def timed_solve(solve):
        def solve_and_time(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = solve(*args)
            torch.cuda.synchronize()
            solves.append(time.perf_counter() - t0)
            return out
        return solve_and_time

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with wrapped(linear, "_lstsq_fit", timed_solve):
        metrics = model.fit(X, Y, groups=groups)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    train_idx, _ = group_kfold_splits(groups, LINEAR_FOLDS)[0]
    tr = torch.as_tensor(train_idx, device="cuda")
    Xtr = X[tr].double()
    Ytr = Y[tr][:, :LINEAR_CHECK_VOXELS].double()
    want = torch.linalg.lstsq(Xtr - Xtr.mean(0), Ytr - Ytr.mean(0)
                              ).solution.cpu().numpy()
    got = model.models[0][0][:, :LINEAR_CHECK_VOXELS]
    err = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    print(f"  (d) T={LINEAR_T}, D={FUSED_D}, V={N_VERTICES}, "
          f"{LINEAR_FOLDS} GroupKFold folds of groups of {LINEAR_GROUP_ROWS} "
          f"rows ({len(train_idx)} training rows in fold 1): fit wall "
          f"{wall:.3f} s, SVD solve per fold "
          f"{[round(t, 3) for t in solves]} s, median r "
          f"{metrics['median_score']:.6f} (floor {FUSED_MEDIAN_R_FLOOR}), "
          f"fold 1's coefficients of {LINEAR_CHECK_VOXELS} voxels against "
          f"float64 lstsq: max |d| / max |ref| {err:.3e} (bar "
          f"{LINEAR_F64_RTOL}); max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB), card: {smi_line}", flush=True)
    if err > LINEAR_F64_RTOL or not metrics["median_score"] \
            > FUSED_MEDIAN_R_FLOOR or len(solves) != LINEAR_FOLDS:
        raise AssertionError("(d) the least-squares fit")


def cli_phase(asm, kv_path, lm_asm, banded, stacked, workdir, smi_line):
    """README section 4's command line at full width: (a) the embeddings
    through cli.main beside phase 5's trainer with the CLI's arguments,
    (b) --banded and --stacking against phase 14 (a)-(b), (c) the layer
    sweep, (d) the least-squares model. Returns (a)'s kernel launches, argv
    and metrics (phase 16 (e) reruns that argv with --n_devices 1)."""
    asm_path = saved_pickle(asm, os.path.join(workdir, "lebel_uts03.pkl"))

    # (a) the embeddings, and phase 5's trainer with the CLI's arguments.
    argv = cli_argv(asm_path, workdir, "cli", "--modality", "embeddings",
                    "--model_name", "random-static", "--vector_path",
                    kv_path)
    m_cli, launches = timed_main("(a) embeddings", argv, smi_line)
    twin = make_trainer(asm, kv_path, "cuda",
                        os.path.join(workdir, "cli_twin_results"))
    m_twin = twin.train(**CLI_TRAIN)
    check_metrics(m_cli, N_VERTICES, np.logspace(-1, 8, 10),
                  m_twin["solver_paths"])
    same_fit("(a) cli.main against phase 5's trainer with the CLI's "
             "arguments", m_cli, m_twin)
    if not m_cli["median_score"] > MEDIAN_R_FLOOR:
        raise AssertionError(f"(a) median r {m_cli['median_score']}")

    # (b) the two feature spaces, --banded then --stacking.
    spaces = ["--modalities", "wordrate", "embeddings", "--model_names",
              "wordrate", "random-static", "--vector_path", kv_path]
    for flag, want, keys in (("--banded", banded,
                              ("best_alphas", "best_gammas")),
                             ("--stacking", stacked, ("best_alphas",))):
        got, _ = timed_main(f"(b) {flag}",
                         cli_argv(asm_path, workdir, flag[2:], *spaces,
                                  flag), smi_line)
        same_fit(f"(b) {flag} against phase 14", got, want, keys)

    cli_layer_sweep(lm_asm, workdir, smi_line)
    linear_full_width(smi_line)
    return launches, argv, m_cli


# Phase 16: the mesh paths (parallel/mesh.py, parallel/tp.py) at full width.
# One card runs them on meshes whose device list repeats cuda:0, the
# counterpart of the JAX tests' virtual CPU devices: the shard, replicate
# and gather logic, the route switches and the tensor-parallel forwards,
# not concurrency across cards. (a) phase 8 (b)'s north-star problem on
# 8 entries (V % 8 = 4: the pad runs) against phase 8 (b): the same alpha
# on at least 99.9% of the voxels, correlations within 1e-4 where they
# agree, median r within 1e-5; n_devices=1 against it: every alpha the same,
# correlations within 1e-6. (b) phase 14 (a)-(b)'s trainers with the models
# on 4 entries: the scan shards, the banded refit is spectral (not grouped
# Cholesky) and the stacked one per-voxel-index Cholesky, so 99.9% of the
# picks and median r within 1e-4. (c) phase 10's 'auto' step on 4 entries:
# 99.9% of the alphas, correlations within 1e-5, shards of V/4. (d) tensor
# parallelism: phase 12's model on a (2, 2) mesh over two of its stories
# and phase 13's encoder on (1, 2) over the first 30 s of its audio, every
# layer within 1e-4 of that layer's largest magnitude (fp32, TF32 off), and
# phase 12's trainer on the TP features of those stories (its other ten
# stories from phase 12's cache): phase 12's alphas on 99.9% of the voxels.
# (e) phase 15 (a)'s argv with --n_devices 1: its alphas and median r
# exactly; --tp_data 1 --tp_model 2 on one card: make_lm_mesh's error.
MESH_ENTRIES_FIT, MESH_ENTRIES = 8, 4
MESH_LM_SHAPE, MESH_SPEECH_SHAPE = (2, 2), (1, 2)
MESH_LM_STORIES, MESH_SPEECH_SECONDS = 2, 30
MESH_TP_RTOL, MESH_SAME_SHARE = 1e-4, 0.999


def mesh_northstar(smi_line, want):
    """(a): phase 8 (b)'s fit on 8 entries of cuda:0 and with n_devices=1."""
    import torch

    from litcoder_core_torch.parallel.mesh import make_mesh

    mb, ab = want
    X, Y = signal_problem(NS_T + NS_TEST, NS_V, 1, n_null=NS_NULL)
    args = (X[:NS_T], Y[:NS_T], X[NS_T:], Y[NS_T:])
    grid = np.logspace(-1, 8, 10)
    mesh = make_mesh(devices=["cuda:0"] * MESH_ENTRIES_FIT)
    with LogLines("litcoder_core_torch.models.nested_cv",
                  "voxel-sharded fit") as log:
        m8, a8 = timed_fit(f"(a) mesh of {MESH_ENTRIES_FIT} x cuda:0", smi_line,
                           *args, mesh=mesh)
    print(f"  (a) {log.messages[0]}", flush=True)
    check_metrics(m8, NS_V, grid, mb["solver_paths"])
    dm = agreement("(a) mesh vs phase 8 (b)", a8, ab, m8, mb,
                   MESH_SAME_SHARE, 1e-4)
    if dm > 1e-5:
        raise AssertionError(f"(a) median r moved by {dm}")
    m1, a1 = timed_fit("(a) n_devices=1", smi_line, *args, n_devices=1)
    check_metrics(m1, NS_V, grid, mb["solver_paths"])
    agreement("(a) n_devices=1 vs phase 8 (b)", a1, ab, m1, mb, 1.0, 1e-6,
              where_same=False)
    del X, Y, args
    torch.cuda.empty_cache()
    if torch.cuda.device_count() == 1:
        try:
            make_mesh(2)
        except RuntimeError as err:
            print(f"  (a) make_mesh(2) on one card: RuntimeError: {err}",
                  flush=True)
        else:
            raise AssertionError("make_mesh(2) built a mesh on one card")


def mesh_trainers(asm, kv_path, workdir, smi_line, want):
    """(b): phase 14 (a)-(b)'s trainers with the models on 4 entries.
    Returns the kernel's launches of both trainers."""
    from litcoder_core_torch.models import BandedRidgeModel, StackedRidgeModel
    from litcoder_core_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cuda:0"] * MESH_ENTRIES)
    m_banded, m_stacked = want
    launches = 0
    for label, model, paths, ref, keys in (
            ("mesh_banded",
             BandedRidgeModel(seed=0, n_gammas=BANDED_N_GAMMAS,
                              device="cuda", mesh=mesh),
             _banded_paths("chol", "spectral"), m_banded,
             ("best_alphas", "best_gammas")),
            ("mesh_stacked",
             StackedRidgeModel(seed=0, device="cuda", mesh=mesh),
             {**STACKED_PATHS, "oof_refit": "pervoxel_chol"}, m_stacked,
             ("best_alphas",))):
        got, n, _ = spaces_trainer_run(label, asm, kv_path, model, workdir,
                                       smi_line, paths)
        launches += n
        same = np.ones(N_VERTICES, bool)
        for key in keys:
            a, b = np.asarray(got[key]), np.asarray(ref[key])
            axis = tuple(i for i in range(a.ndim) if a.shape[i] != N_VERTICES)
            same &= np.all(a == b, axis=axis) if axis else a == b
        dm = abs(got["median_score"] - ref["median_score"])
        print(f"  (b) {label} vs phase 14: the same {', '.join(keys)} on "
              f"{same.mean():.4%} of the voxels, |d median r| {dm:.3e} "
              f"(bar 1e-4), solver_paths {got['solver_paths']}", flush=True)
        if same.mean() < MESH_SAME_SHARE or dm > 1e-4:
            raise AssertionError(f"(b) {label} disagrees with phase 14")
    return launches


def mesh_step(smi_line, want):
    """(c): phase 10's 'auto' step on 4 entries."""
    import torch

    from litcoder_core_torch.parallel.mesh import make_mesh
    from litcoder_core_torch.parallel.step import (
        equal_size_folds,
        make_nested_cv_step,
    )

    args = bench_problem(0)
    folds = equal_size_folds(BENCH_T, BENCH_F, BENCH_CHUNK, seed=0)
    grid = np.logspace(-1, 8, BENCH_A).astype(np.float32)
    mesh = make_mesh(devices=["cuda:0"] * MESH_ENTRIES)
    step = make_nested_cv_step(mesh=mesh, device="cuda")

    def run():
        out = step(*args, grid, *folds)
        torch.cuda.synchronize()
        return out

    with LogLines(STEP_LOGGER, "nested_cv_step:") as log:
        run()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = run()
        walls.append(time.perf_counter() - t0)
    widths = {tuple(s.shape) for s in out.weights.shards}
    corr, _, alphas, _ = (f.gather("cuda").cpu().numpy() for f in out)
    metrics = {"correlations": corr, "median_score": float(np.median(corr))}
    print(f"  (c) {log.messages[0]}; walls "
          f"{', '.join(f'{w:.4f}' for w in walls)} s (median "
          f"{float(np.median(walls)):.4f}); weight shards {sorted(widths)}; "
          f"median r {metrics['median_score']:.6f}, card: {smi_line}",
          flush=True)
    if widths != {(BENCH_D, N_VERTICES // MESH_ENTRIES)}:
        raise AssertionError(f"(c) shards {widths}")
    agreement("(c) mesh step vs phase 10 'auto'", alphas, want[0], metrics,
              want[1], MESH_SAME_SHARE, 1e-5)
    del args, out
    torch.cuda.empty_cache()


def cache_layers(path):
    """{layer: features} of one activation-cache file."""
    from litcoder_core_torch.utils.caches import LazyLayerCache

    lazy = LazyLayerCache(path)
    return {int(i): lazy.get_layer(int(i))
            for i in lazy.get_metadata()["available_layers"]}


def mesh_lm(lm_asm, workdir, smi_line, want):
    """(d), language model: phase 12's trainer with the extractor on a
    (2, 2) mesh, its cache a copy of phase 12's without two stories, so
    those two are extracted tensor-parallel. Returns the launches."""
    import copy
    import glob
    import shutil

    import torch

    from litcoder_core_torch.ops import lanczos_fir as lf
    from litcoder_core_torch.parallel.tp import make_lm_mesh
    from litcoder_core_torch.utils.caches import LazyLayerCache

    m_lm, rate = want
    src = os.path.join(workdir, "lm_cache")
    dst = os.path.join(workdir, "lm_tp_cache")
    shutil.copytree(src, dst)
    redo = set(lm_asm.stories[:MESH_LM_STORIES])
    plain = {}
    for path in glob.glob(os.path.join(dst, "*.npz")):
        story = LazyLayerCache(path).get_metadata()["story"]
        if story in redo:
            plain[story] = cache_layers(os.path.join(
                src, os.path.basename(path)))
            os.remove(path)
    if set(plain) != redo:
        raise AssertionError(f"(d) phase 12's cache lacks {redo - set(plain)}")
    model, _ = lm_model(GPT2_SMALL)
    card_model = copy.deepcopy(model).to("cuda")
    del model
    mesh = make_lm_mesh(*MESH_LM_SHAPE, devices=["cuda:0"] * 4)
    trainer, ex = lm_trainer(lm_asm, card_model, "cuda", workdir, "lm_tp",
                             LM_LAYER, mesh=mesh)
    stage = summed_stage_seconds(ex)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lf.launches = 0
    t0 = time.perf_counter()
    metrics = trainer.train(chunk_length=20, n_inner_folds=5)
    wall = time.perf_counter() - t0
    launches = lf.launches
    peak = torch.cuda.max_memory_allocated()
    counts = dict(ex.counts)
    extract_s = stage.get("tokenize_s", 0.0) + stage.get("forward_total_s",
                                                         0.0)
    n_windows = sum(len(lm_asm.story_data[s].stimuli) for s in redo)
    print(f"  (d) LM on a {MESH_LM_SHAPE} mesh: {counts['windows']} windows "
          f"of {sorted(redo)} in {counts['chain_forwards']} chain and "
          f"{counts['single_forwards']} single forwards, "
          f"{counts['windows'] / extract_s:.1f} windows/s against phase "
          f"12's unsharded {rate:.1f}; lanczos_fir launches {launches}",
          flush=True)
    if counts["windows"] != n_windows or launches != LM_STORIES:
        raise AssertionError(f"(d) {counts['windows']} windows, {launches} "
                             "launches")
    for path in glob.glob(os.path.join(dst, "*.npz")):
        story = LazyLayerCache(path).get_metadata()["story"]
        if story in redo:
            compare_layers(f"(d) story {story}, TP vs unsharded features",
                           cache_layers(path), plain[story], MESH_TP_RTOL)
    check_metrics(metrics, N_VERTICES, np.logspace(-1, 8, 10), LM_PATHS)
    report_path_run(metrics, wall, peak, smi_line, None)
    same = np.asarray(metrics["best_alphas"]) == np.asarray(
        m_lm["best_alphas"])
    print(f"  (d) the trainer on the TP features vs phase 12: the same alpha "
          f"on {same.mean():.4%} of the voxels, |d median r| "
          f"{abs(metrics['median_score'] - m_lm['median_score']):.3e}",
          flush=True)
    if same.mean() < MESH_SAME_SHARE:
        raise AssertionError("(d) the TP trainer's alphas differ")
    return launches


def mesh_speech(audio_path, workdir):
    """(d), speech: phase 13's encoder on a (1, 2) mesh over the first
    MESH_SPEECH_SECONDS of its audio, against the unsharded extractor."""
    import copy

    import torch
    from scipy.io import wavfile

    from litcoder_core_torch.features.speech_model import load_audio
    from litcoder_core_torch.parallel.tp import make_lm_mesh

    path = os.path.join(workdir, "speech_first_30s.wav")
    wavfile.write(path, SPEECH_SR,
                  load_audio(audio_path, SPEECH_SR)[:MESH_SPEECH_SECONDS
                                                    * SPEECH_SR])
    model, fe = speech_model({})
    card_model = copy.deepcopy(model).to("cuda")
    del model
    feats, rates = [], []
    for mesh in (None, make_lm_mesh(*MESH_SPEECH_SHAPE,
                                    devices=["cuda:0"] * 2)):
        ex = speech_extractor(card_model, fe, "cuda", SPEECH_CHUNK,
                              SPEECH_CONTEXT, mesh=mesh)
        ex.extract_all_layers(path)          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, times = ex.extract_all_layers(path)
        torch.cuda.synchronize()
        rates.append(len(times) / (time.perf_counter() - t0))
        feats.append((got, times))
    (want, t_want), (got, t_got) = feats
    if not np.array_equal(t_got, t_want):
        raise AssertionError("(d) speech window times differ")
    compare_layers(f"(d) speech on a {MESH_SPEECH_SHAPE} mesh, "
                   f"{len(t_got)} windows, TP vs unsharded", got, want,
                   MESH_TP_RTOL)
    print(f"  (d) speech: {rates[1]:.1f} windows/s on the mesh against "
          f"{rates[0]:.1f} unsharded", flush=True)


def mesh_cli(cli_args, smi_line):
    """(e): phase 15 (a)'s argv with --n_devices 1, then an extraction mesh
    of two entries on one card."""
    import torch

    from litcoder_core_torch import cli

    argv, m_cli = cli_args
    got, launches = timed_main("(e) --n_devices 1", argv + ["--n_devices",
                                                           "1"], smi_line)
    dm = abs(got["median_score"] - m_cli["median_score"])
    print(f"  (e) against phase 15 (a): same alphas "
          f"{got['best_alphas'] == m_cli['best_alphas']}, |d median r| "
          f"{dm:.3e}, solver_paths {got['solver_paths']}", flush=True)
    if (got["best_alphas"] != m_cli["best_alphas"] or dm != 0.0
            or got["solver_paths"] != m_cli["solver_paths"]):
        raise AssertionError("(e) --n_devices 1 changed the fit")
    if torch.cuda.device_count() == 1:
        tp_argv = argv + ["--modality", "language_model", "--model_name",
                          "gpt2", "--tp_data", "1", "--tp_model", "2"]
        try:
            cli.main(tp_argv)
        except RuntimeError as err:
            print(f"  (e) --tp_data 1 --tp_model 2 on one card: "
                  f"RuntimeError: {err}", flush=True)
        else:
            raise AssertionError("(e) a 2-entry extraction mesh was built on "
                                 "one card")
    return launches


def mesh_phase(asm, kv_path, lm_asm, workdir, smi_line, northstar_fit,
               spaces_fits, step_auto, lm_run, audio_path, cli_args):
    """Phase 16 (a)-(e). Returns the kernel's launches in its trainers."""
    t0 = time.perf_counter()
    mesh_northstar(smi_line, northstar_fit)
    launches = mesh_trainers(asm, kv_path, workdir, smi_line, spaces_fits)
    mesh_step(smi_line, step_auto)
    launches += mesh_lm(lm_asm, workdir, smi_line, lm_run)
    mesh_speech(audio_path, workdir)
    launches += mesh_cli(cli_args, smi_line)
    print(f"  phase 16 lanczos_fir launches {launches} ({N_STORIES} + "
          f"{N_STORIES} + {LM_STORIES} + {N_STORIES}); phase 16 wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def main() -> int:
    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from litcoder_core_torch.ops import lanczos_fir as lf

    smi_line = nvidia_smi_line()
    print(f"  {smi_line}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
          flush=True)

    phase("2 build")
    _, report = lf.build()
    print(f"  built {report['path']} in {report['seconds']:.2f} s", flush=True)
    for line in report["log"].splitlines():
        if any(key in line for key in ("Compiling entry", "registers",
                                       "spill", "smem")):
            print(f"  ptxas: {line.strip()}", flush=True)
    print(f"  optional packages: {optional_packages()}", flush=True)

    phase("3 kernel vs plain on the card")
    record = kernel_phase(torch.device("cuda"))

    with tempfile.TemporaryDirectory() as workdir:
        phase("4 small end-to-end parity, card vs CPU")
        small_parity_phase(workdir)
        solver_cases_phase()
        step_cases_phase()
        small_downsample_phase()
        small_lm_phase(workdir)
        small_speech_phase(workdir)
        banded_cases_phase()
        small_cli_phase(workdir)

        phase("5 main path at full size")
        record["launches"], asm, kv_path = main_path_phase(workdir, smi_line)

        phase("6 Narratives path at full width, full nested CV")
        record["launches_narratives"] = narratives_phase(workdir, smi_line)

        phase("7 fused full-CV route at full size")
        fused_full_cv_phase(smi_line)

        phase("8 north-star whole-brain fit, V=95556")
        northstar_fit = northstar_phase(smi_line)

        phase("9 eigh search at full width")
        eigh_search_phase(smi_line)

        phase("10 fused nested-CV step at full size")
        step_auto = bench_step_phase(smi_line)
        step_full_width_phase(smi_line)

        phase("11 the other downsamplers at full size")
        full_downsample_phase(asm, kv_path)
        average_trainer_phase(asm, kv_path, workdir, smi_line)

        phase("12 language-model trainer at full width")
        record["launches_lm"], lm_asm, m_lm, lm_rate = lm_phase(
            asm, workdir, smi_line)

        phase("13 README section 3 with speech features at full width")
        record["launches_speech"], audio_path = speech_phase(workdir,
                                                             smi_line)

        phase("14 README section 4's --banded fit at full width")
        record["launches_banded"], m_banded, m_stacked = banded_phase(
            asm, kv_path, workdir, smi_line)

        phase("15 README section 4's command line at full width")
        record["launches_cli"], cli_args, m_cli = cli_phase(
            asm, kv_path, lm_asm, m_banded, m_stacked, workdir, smi_line)

        phase("16 the mesh paths at full width, meshes of cuda:0")
        record["launches_mesh"] = mesh_phase(
            asm, kv_path, lm_asm, workdir, smi_line, northstar_fit,
            (m_banded, m_stacked), step_auto, (m_lm, lm_rate), audio_path,
            (cli_args, m_cli))

    print(smi_line, flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
