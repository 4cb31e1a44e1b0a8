"""lm_windows_per_s.train: windows the LM extractor pooled (its `counts`)
over the seconds of the trainer's extraction stage, over the window's
train() calls."""


def read(reading):
    windows = sum(r["program"]["counts"]["windows"] for r in reading.records)
    seconds = sum(r["program"]["stage_seconds"].get(
        "extract_downsample_fir_fused", 0.0) for r in reading.records)
    return windows / seconds if windows and seconds else None
