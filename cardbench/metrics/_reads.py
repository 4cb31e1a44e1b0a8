"""What several metric readers share: device time by kernel family, the
share of the float32 peak, the device's idle share. Trace-read values
describe the traced jobs (harness.TRACE_SECONDS); None where the run has
nothing to read (no trace, no such kernel)."""

GEMM = ("gemm", "gemv", "xmma")
CUSOLVER = ("potrf", "potrs", "trsm", "trsv", "getrf", "getrs", "laswp",
            "syevd", "syev", "sytrd", "stedc", "steqr", "ormtr", "orgtr",
            "larft", "larfb", "larfg", "lansy", "chol")


def device_ms_per_job(reading, family):
    t = reading.trace
    if t is None or not t.launches(family):
        return None
    return 1e3 * t.device_s(family) / reading.traced_jobs


def mfu(reading):
    """The job's operations (the entry's flops(), metrics/_counts.py) over
    the seconds per traced job, as a share of the float32 peak, in %."""
    t = reading.trace
    if t is None or not reading.traced_jobs or reading.cell.device != "cuda":
        return None
    seconds = t.window_s / reading.traced_jobs
    return 100.0 * reading.job.flops() / seconds / reading.peaks[
        "f32_flop_per_s"]


def idle_share(reading):
    """Share of the traced window with no kernel, copy or memset on the
    device, in %."""
    t = reading.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def seconds_per_job(reading):
    return reading.window_s / reading.jobs
