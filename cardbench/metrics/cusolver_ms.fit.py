"""cusolver_ms.fit: device milliseconds per traced fit in the
factorizations and solves (Cholesky, triangular solves, LU, the symmetric
eigensolver's stages), by kernel name."""

from cardbench.metrics._reads import CUSOLVER, device_ms_per_job


def read(reading):
    return device_ms_per_job(reading, CUSOLVER)
