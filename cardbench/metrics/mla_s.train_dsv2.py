"""mla_s.train_dsv2: device-stream seconds per traced train() in the
`litcoder.lm.mla` spans, DeepSeek-V2's multi-head latent attention
(projections, RoPE, SDPA, o_proj) of every layer of every forward
(metrics/_spans.py)."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.lm.mla", "device")
