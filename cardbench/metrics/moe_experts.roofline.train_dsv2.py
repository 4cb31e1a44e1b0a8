"""moe_experts.roofline.train_dsv2: the routed experts' grouped GEMMs'
least time over their device time in the trace, in percent. A call's
least time is the larger of its bytes over the peak bandwidth and its
operations over the bf16 dense peak (989 TFLOP/s, NVIDIA H100 SXM data
sheet, at 700 W), each counted by metrics/_counts_moe.expert_gemm_counts
from the rows and the experts hit that each traced `litcoder.lm.moe`
span recorded. The kernels are those torch._grouped_mm runs on sm_90
(torch 2.11): CUTLASS 3 grouped GEMMs (KernelPtrArrayTmaWarpSpecialized-
Cooperative), the only kernels whose names hold GroupProblemShape."""

from cardbench.metrics._counts_moe import expert_gemm_counts
from cardbench.metrics._spans import record

BF16_FLOP_PER_S = 989e12
KERNELS = ("GroupProblemShape",)


def read(reading):
    trace = reading.trace
    if trace is None or not trace.launches(KERNELS):
        return None
    seconds = trace.device_s(KERNELS)
    c = reading.cell.config
    bound = 0.0
    for s in record():
        counts = s["counts"]
        if s["name"] != "litcoder.lm.moe" or "experts_hit" not in counts:
            continue
        n_bytes, ops = expert_gemm_counts(counts["tokens"],
                                          counts["experts_hit"], c)
        bound += max(n_bytes / reading.peaks["bytes_per_s"],
                     ops / BF16_FLOP_PER_S)
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds
