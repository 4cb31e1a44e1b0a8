"""moe_s.train_dsv2: device-stream seconds per traced train() in the
`litcoder.lm.moe` spans, DeepSeek-V2's MoE layers (router, sort, grouped
expert GEMMs, combine, shared experts; metrics/_spans.py)."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.lm.moe", "device")
