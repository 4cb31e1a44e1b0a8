"""extract_s.train: the trainer's extraction stage
(trainer_stage_seconds['extract_downsample_fir_fused']: the LM forwards,
tokenizing and the fused kernel), mean seconds per train()."""


def read(reading):
    stages = [r["program"]["stage_seconds"] for r in reading.records]
    values = [s["extract_downsample_fir_fused"] for s in stages
              if "extract_downsample_fir_fused" in s]
    return sum(values) / len(values) if values else None
