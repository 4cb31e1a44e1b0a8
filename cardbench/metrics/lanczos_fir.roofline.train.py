"""lanczos_fir.roofline.train: the fused Lanczos + FIR kernel's least time
over its device time in the trace, in percent. The least time of a launch
is the larger of its bytes over the peak bandwidth and its operations over
the float32 peak (metrics/_counts.lanczos_fir_counts, from the stories'
shapes and times)."""

KERNEL = "lanczos_fir_kernel"


def read(reading):
    trace = reading.trace
    if trace is None:
        return None
    seconds = trace.device_s([KERNEL])
    if seconds <= 0:
        return None
    peaks = reading.peaks
    bound = sum(max(b / peaks["bytes_per_s"], f / peaks["f32_flop_per_s"])
                for b, f in reading.job.kernel_counts())
    return 100.0 * bound * reading.traced_jobs / seconds
