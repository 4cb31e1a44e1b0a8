"""mfu.train_dsv2: a train()'s least time at the card's peaks over the
seconds per traced train(), in percent. The least time is the LM
forwards' operations (metrics/_counts_moe.lm_flops: real tokens under
causal prefix reuse, DeepSeek-V2-Lite's active parameters) over the bf16
dense peak (989 TFLOP/s, NVIDIA H100 SXM data sheet, at 700 W), plus the
fit's (metrics/_counts.py) over the float32 peak of peaks.json."""

BF16_FLOP_PER_S = 989e12


def read(reading):
    t = reading.trace
    if t is None or not reading.traced_jobs or reading.cell.device != "cuda":
        return None
    job = reading.job
    least = (job.lm_flops() / BF16_FLOP_PER_S
             + job.fit_flops() / reading.peaks["f32_flop_per_s"])
    return 100.0 * least / (t.window_s / reading.traced_jobs)
