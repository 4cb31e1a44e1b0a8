#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (litcoder_core_torch) on one NVIDIA card.

Run from the repository root: python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:
  1. device: a CUDA card is required; its name and power limit as nvidia-smi
     reports them.
  2. build: nvcc builds csrc/lanczos_fir.cu from the checkout.
  3. kernel: the fused Lanczos+FIR CUDA kernel against its plain torch
     version on the card (atol 1e-4, the bar the TPU kernel met against the
     two-stage path), at the trainer's main shape, at the main shape with
     word times permuted, with a 60 s silent gap and with descending TR
     times, at the shapes of tests/test_pallas_kernels.py and at one shape
     of two scan passes; the word tiles each launch visits beside the dense
     count. Times at the main shape: the kernel and torch.matmul(K_all,
     data) each as back-to-back launches between one pair of CUDA events,
     rotating over 12 operand sets (12 x 8.9 MB > the 50 MB L2, so each
     launch finds its operands cold), and as single calls.
  4. small parity: the port's AbstractTrainer on a small synthetic assembly,
     on the card and on the CPU: same alphas, correlations within 2e-3,
     median r within 1e-3.
  5. main path: AbstractTrainer(...).train() on the card at full width, a
     LeBel-UTS03-shaped synthetic assembly (85 stories of 320 TRs, 768-wide
     static embeddings, FIR delays 1-4, V=20484 fsaverage5 vertices,
     10 alphas, 5 inner folds, chunks of 20 TRs).
The last two lines are a JSON record of the kernel and
{"ok": true, "device": {...}}.

Imports nothing of JAX or of litcoder_core_tpu.
"""

import json
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

# Back-to-back timing: TIMING_SETS distinct operand sets, each launched
# TIMING_ROUNDS times per timed run. A spin kernel of HOLD_CYCLES clock
# cycles holds the stream while the host enqueues, so the host's launch
# overhead does not enter the device time.
TIMING_SETS = 12
TIMING_ROUNDS = 10
HOLD_CYCLES = 20_000_000

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


def phase(name):
    print(f"[phase] {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
    such runs. Raises if the host took longer to enqueue them than the
    spin kernel held the stream, since the device would then have waited
    on the host."""
    import torch

    for fn in launchers:
        fn()
    hold = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n = rounds * len(launchers)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        hold.record()
        torch.cuda._sleep(HOLD_CYCLES)
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
            raise AssertionError(f"enqueueing {n} launches took {host_ms:.2f}"
                                 f" ms, longer than the {hold_ms:.2f} ms hold")
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


def kernel_phase(device):
    """Kernel vs plain version on the card; times at the main shape."""
    import torch

    from litcoder_core_torch.ops import lanczos_fir as lf
    from litcoder_core_torch.ops.interp import lanczos_matrix

    rng = np.random.default_rng(0)
    cases = [(label, MAIN_SHAPE["delays"], data, dt, tt)
             for label, data, dt, tt in main_shape_cases(rng)]
    for label, shapes in (("test shape", TEST_SHAPES),
                          ("path shape", PATH_SHAPES)):
        for t_w, dim, t_tr, delays, span in shapes:
            data = rng.normal(size=(t_w, dim)).astype(np.float32)
            dt, tt = make_times(rng, t_w, t_tr, span)
            cases.append((label, delays, data, dt, tt))
    max_err = 0.0
    for label, delays, data_np, dt_np, tt_np in cases:
        data = torch.as_tensor(data_np, device=device)
        dt = torch.as_tensor(dt_np, device=device)
        tt = torch.as_tensor(tt_np, device=device)
        got = lf.lanczos_fir(data, dt, tt, delays, window=3, cutoff_mult=1.0,
                             device=device)
        ref = lf.lanczos_fir_reference(data, dt, tt, delays, 3, 1.0)
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            raise AssertionError(f"shape {tuple(got.shape)} != "
                                 f"{tuple(ref.shape)}")
        err = float((got - ref).abs().max())
        live = lf.live_word_tiles(dt, tt)
        print(f"  kernel vs plain, {label} t_w={data.shape[0]} "
              f"d={data.shape[1]} t_tr={tt.shape[0]} delays={delays}: "
              f"max_abs_err={err:.3e}; word tiles visited per column slab "
              f"{int(live.sum())} of {live.numel()} dense", flush=True)
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"by {err} > {KERNEL_ATOL}")
        max_err = max(max_err, err)

    # Times at the main shape (sorted word times), each timing set with its
    # own copy of every operand.
    t_w, dim, t_tr, delays = (MAIN_SHAPE[k] for k in
                              ("t_w", "dim", "t_tr", "delays"))
    _, data_np, dt_np, tt_np = main_shape_cases(rng)[0]
    data = torch.as_tensor(data_np, device=device)
    dt = torch.as_tensor(dt_np, device=device)
    tt = torch.as_tensor(tt_np, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    K_all = lf.shifted_lanczos_stack(dt, tt, delays, 3, 1.0)
    kernel_sets, library_sets = [], []
    for _ in range(TIMING_SETS):
        d = torch.randn((t_w, dim), device=device, generator=gen)
        dt_i, tt_i = dt.clone(), tt.clone()
        kernel_sets.append((d, dt_i, tt_i)
                           + lf.prepare_launch(d, dt_i, tt_i, delays, 1.0))
        library_sets.append((K_all.clone(), d.clone(), torch.empty(
            (len(delays) * t_tr, dim), device=device)))
    ms = back_to_back_ms([lambda s=s: lf.launch(*s, 3) for s in kernel_sets])
    library_ms = back_to_back_ms(
        [lambda s=s: torch.matmul(s[0], s[1], out=s[2])
         for s in library_sets])
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
    record = {
        "name": "lanczos_fir",
        "route": "cuda",
        "source": "litcoder_core_torch/csrc/lanczos_fir.cu",
        "replaces": "litcoder_core_tpu/ops/pallas_kernels.py:33",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "ms_single_call": ms_single,
        "library_ms_single_call": library_single,
    }
    print(f"  main shape t_w={t_w} t_tr={t_tr} d={dim} delays={delays}, "
          f"back to back over {TIMING_SETS} operand sets: kernel {ms:.5f} ms "
          f"({record['bound_ms'] / ms:.1%} of the bound), matmul(K_all, "
          f"data) {library_ms:.5f} ms; single calls: kernel "
          f"{ms_single:.5f} ms, matmul {library_single:.5f} ms, plain "
          f"{plain_ms:.5f} ms; bound {record['bound_ms']:.5f} ms "
          f"({record['bound_by']}: {n_bytes} bytes, {n_ops} flop from "
          f"{nnz} nonzero weights)", flush=True)
    return record


def make_story(rng, name, n_tr, words_per_s, vocab, emb, proj, mix,
               noise_std, n_vox, story_cls, signal_out=None):
    """One LeBel-shaped synthetic story: word times at ~words_per_s, brain
    data of n_tr - 15 rows carrying a low-rank signal of the delayed
    Lanczos-downsampled embeddings plus Gaussian noise."""
    import torch

    from litcoder_core_torch.ops.lanczos_fir import lanczos_fir_reference

    span = n_tr * TR_SECONDS
    n_words = int(rng.integers(int(0.95 * span * words_per_s),
                               int(1.05 * span * words_per_s)))
    data_times = np.sort(rng.uniform(0, span, n_words)).astype(np.float32)
    tr_times = (np.arange(n_tr) * TR_SECONDS + TR_SECONDS / 2).astype(
        np.float32)
    word_ids = rng.integers(0, len(vocab), n_words)
    words = [vocab[i] for i in word_ids]
    split = np.clip((data_times // TR_SECONDS).astype(int), 0, n_tr - 1)
    low = torch.as_tensor(emb[word_ids] @ proj)
    feats = lanczos_fir_reference(low, torch.as_tensor(data_times),
                                  torch.as_tensor(tr_times),
                                  (1, 2, 3, 4)).numpy()
    signal = (feats @ mix)[10:n_tr - 5]
    brain = signal + noise_std * rng.standard_normal(
        (n_tr - 15, n_vox), dtype=np.float32)
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
                   kv_path, noise_std):
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
    mix = (rng.standard_normal((4 * SIGNAL_RANK, n_vox), dtype=np.float32)
           / np.sqrt(4 * SIGNAL_RANK))
    signal_var = []
    stories = [
        make_story(rng, f"story{i:03d}", n_tr, WORDS_PER_S, vocab, emb,
                   proj, mix, noise_std, n_vox, StoryData, signal_var)
        for i in range(n_stories)
    ]
    s2 = float(np.mean(signal_var))
    return (SimpleNeuroidAssembly(stories, validation_method="outer"),
            float(np.sqrt(s2 / (s2 + noise_std**2))))


def make_trainer(assembly, kv_path, device, results_dir):
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
        fir_delays=[1, 2, 3, 4],
        trimming_config=dict(LEBEL_TRIM),
        use_train_test_split=True,
        dataset_type="lebel",
        logger_backend="none",
        results_dir=results_dir,
        downsample_config={"method": "lanczos", "window": 3,
                           "cutoff_mult": 1.0},
        device=device,
    )


EXPECTED_PATHS = {"mode": "train_test", "alpha_search": "chol",
                  "fast_scan": "off"}


def check_metrics(metrics, n_vox, alphas_grid):
    corr = np.asarray(metrics["correlations"])
    if corr.shape != (n_vox,) or not np.all(np.isfinite(corr)):
        raise AssertionError(f"correlations: shape {corr.shape}, finite "
                             f"{np.isfinite(corr).all()}")
    p = np.asarray(metrics["p_values"])
    if not (np.all(np.isfinite(p)) and np.all((p >= 0) & (p <= 1))):
        raise AssertionError("p-values not finite in [0, 1]")
    alphas = np.asarray(metrics["best_alphas"], np.float32)
    if not np.all(np.isin(alphas, np.asarray(alphas_grid, np.float32))):
        raise AssertionError("best alphas outside the grid")
    if metrics["solver_paths"] != EXPECTED_PATHS:
        raise AssertionError(f"solver_paths {metrics['solver_paths']}")


def small_parity_phase(workdir):
    """The port's trainer on a small assembly, on the card and the CPU."""
    from litcoder_core_torch.ops import lanczos_fir as lf

    kv_path = os.path.join(workdir, "small.kv")
    asm, _ = build_assembly(1, 4, 120, 6, 40, 400, kv_path, 1.0)
    results = {}
    for device in ("cuda", "cpu"):
        before = lf.launches
        results[device] = make_trainer(
            asm, kv_path, device, os.path.join(workdir, f"small_{device}")
        ).train(chunk_length=10, n_inner_folds=3)
        check_metrics(results[device], 40, np.logspace(-1, 8, 10))
        print(f"  {device}: median r {results[device]['median_score']:.6f}, "
              f"kernel launches {lf.launches - before}", flush=True)
    gpu, cpu = results["cuda"], results["cpu"]
    if gpu["best_alphas"] != cpu["best_alphas"]:
        raise AssertionError("card and CPU selected different alphas")
    dr = float(np.max(np.abs(np.asarray(gpu["correlations"])
                             - np.asarray(cpu["correlations"]))))
    dm = abs(gpu["median_score"] - cpu["median_score"])
    print(f"  card vs CPU: same alphas, max |dr| {dr:.3e} (bar 2e-3), "
          f"|d median| {dm:.3e} (bar 1e-3)", flush=True)
    if dr > 2e-3 or dm > 1e-3:
        raise AssertionError("card and CPU correlations disagree")


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
    print(f"  trainer_stage_seconds {json.dumps(metrics['trainer_stage_seconds'])}"
          f" (train() wall {wall:.3f} s)", flush=True)
    print(f"  median r {metrics['median_score']:.6f} (floor "
          f"{MEDIAN_R_FLOOR}), n_significant {metrics['n_significant']}",
          flush=True)
    print(f"  solver_paths {metrics['solver_paths']}", flush=True)
    print(f"  lanczos_fir launches {launches}, max_memory_allocated "
          f"{peak} bytes ({peak / 2**30:.2f} GiB), card: {smi_line}",
          flush=True)
    if launches < N_STORIES:
        raise AssertionError(f"the kernel ran {launches} times, fewer than "
                             f"the {N_STORIES} stories")
    if not metrics["median_score"] > MEDIAN_R_FLOOR:
        raise AssertionError(f"median r {metrics['median_score']} <= "
                             f"{MEDIAN_R_FLOOR}")
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

    phase("3 kernel vs plain on the card")
    record = kernel_phase(torch.device("cuda"))

    with tempfile.TemporaryDirectory() as workdir:
        phase("4 small end-to-end parity, card vs CPU")
        small_parity_phase(workdir)

        phase("5 main path at full size")
        record["launches"] = main_path_phase(workdir, smi_line)

    print(smi_line, flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
