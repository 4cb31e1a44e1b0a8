"""gemm_ms.fit: device milliseconds per traced fit in cuBLAS's matrix
products (kernel names holding gemm, gemv or xmma)."""

from cardbench.metrics._reads import GEMM, device_ms_per_job


def read(reading):
    return device_ms_per_job(reading, GEMM)
