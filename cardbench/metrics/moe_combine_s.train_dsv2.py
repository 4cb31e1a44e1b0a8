"""moe_combine_s.train_dsv2: device-stream seconds per traced train() in the
`litcoder.lm.moe.combine` spans, the weighted combine of DeepSeek-V2's
routed experts' rows (the inverse permutation and the combine, inside each
`litcoder.lm.moe`; metrics/_spans.py). None where the program records no
such span."""

from cardbench.metrics._spans import seconds_per_job


def read(reading):
    return seconds_per_job(reading, "litcoder.lm.moe.combine", "device")
