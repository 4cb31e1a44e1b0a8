"""One step of the Lanczos recurrence of models/ridge.py's lambda-max.

The step is everything after the operator's matvec: the three-term update,
the full reorthogonalisation against the basis, the norm, the breakdown
test and the writes of the basis row, the tridiagonal's entries and the
next vector. `lanczos_step_reference` is its plain version, the
recurrence's torch ops. `LanczosSteps` runs the steps of one recurrence
and dispatches on the device: the plain version for the CPU only, the
hand-written kernel in csrc/lanczos_step.cu otherwise, one launch a step
(it launches or raises; nothing falls back).

Both versions work in place on the caller's buffers: v (n,), v_prev (n,),
which receives the next vector, basis (m, n) and diag, off (m,), all zero
where not yet written, and state (2,) = (b_prev, scale), zero at the start.
The caller then swaps v and v_prev. w = A v is only read.

`launches` counts kernel launches, so a run can show that its steps went
through the kernel.
"""

import ctypes

import torch

launches = 0

_KERNEL = "lanczos_step"

# The most steps of one recurrence the kernel takes (kMaxSteps in
# csrc/lanczos_step.cu: the step's coefficients sit in shared memory).
MAX_STEPS = 8192


def lanczos_step_reference(w: torch.Tensor, v: torch.Tensor,
                           v_prev: torch.Tensor, basis: torch.Tensor,
                           diag: torch.Tensor, off: torch.Tensor,
                           state: torch.Tensor, i: int) -> None:
    """Step i in torch ops: the same quantities as the kernel, with the
    reorthogonalisation as two products over the whole (zero-padded)
    basis."""
    a = torch.dot(w, v)
    w = w - a * v - state[0] * v_prev
    w = w - basis.T @ (basis @ w)
    b = torch.linalg.norm(w)
    scale = torch.maximum(state[1], torch.abs(a))
    alive = b > 1e-6 * torch.clamp(scale, min=1.0)
    v_next = torch.where(alive, w / torch.clamp(b, min=1e-30), 0.0)
    b = torch.where(alive, b, 0.0)
    basis[i] = v
    diag[i] = a
    off[i] = b
    v_prev.copy_(v_next)
    state[0] = b
    state[1] = scale


def build():
    """Build (or load) the kernel's library; returns (C entry point, build
    report). The entry point's argument types are declared here, so ctypes
    passes pointers and the stream as 64-bit values."""
    from litcoder_core_torch.ops import cuda_build

    lib, report = cuda_build.load(_KERNEL)
    fn = lib.lanczos_step_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn, report


def _check(name: str, t: torch.Tensor, shape, dev) -> None:
    if t.device != dev or t.dtype != torch.float32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous float32 tensor of shape {shape} "
            f"on {dev}; got {tuple(t.shape)} {t.dtype} on {t.device}"
        )


def _check_operands(v: torch.Tensor, v_prev: torch.Tensor,
                    basis: torch.Tensor, diag: torch.Tensor,
                    off: torch.Tensor, state: torch.Tensor) -> None:
    """Check the buffers that every kernel step of one recurrence
    shares."""
    if basis.ndim != 2:
        raise ValueError(f"basis must be (m, n); got {tuple(basis.shape)}")
    m, n = basis.shape
    if not 0 < m <= min(n, MAX_STEPS):
        raise ValueError(f"the kernel takes 1 to min(n, {MAX_STEPS}) steps; "
                         f"got m={m} for n={n}")
    dev = v.device
    if dev.type != "cuda":
        raise ValueError("the lanczos_step kernel needs CUDA tensors, "
                         f"got {dev}")
    for name, t, shape in (("v", v, (n,)), ("v_prev", v_prev, (n,)),
                           ("basis", basis, (m, n)), ("diag", diag, (m,)),
                           ("off", off, (m,)), ("state", state, (2,))):
        _check(name, t, shape, dev)


class LanczosSteps:
    """The steps of one recurrence on its buffers: the plain version on the
    CPU, the kernel elsewhere, launched on the stream current when the
    object was made (the buffers are checked once, here; a step checks only
    w). Calling it with w = A v runs step i and swaps v and v_prev; `v` is
    the vector the next matvec takes."""

    def __init__(self, v: torch.Tensor, v_prev: torch.Tensor,
                 basis: torch.Tensor, diag: torch.Tensor, off: torch.Tensor,
                 state: torch.Tensor):
        self.v, self.v_prev = v, v_prev
        self._buffers = (basis, diag, off, state)
        self._m, self._n = basis.shape
        self.fused = v.device.type != "cpu"
        if self.fused:
            _check_operands(v, v_prev, basis, diag, off, state)
            self._fn, _ = build()
            self._stream = torch.cuda.current_stream(v.device).cuda_stream
            self._pointers = [t.data_ptr() for t in self._buffers]

    def __call__(self, w: torch.Tensor, i: int) -> None:
        if self.fused:
            self._launch(w, i)
        else:
            lanczos_step_reference(w, self.v, self.v_prev, *self._buffers, i)
        self.v, self.v_prev = self.v_prev, self.v

    def _launch(self, w: torch.Tensor, i: int) -> None:
        global launches
        m, n = self._m, self._n
        _check("w", w, (n,), self.v.device)
        if not 0 <= i < m:
            raise ValueError(f"step {i} outside 0..{m - 1}")
        err = self._fn(w.data_ptr(), self.v.data_ptr(),
                       self.v_prev.data_ptr(), *self._pointers, n, m, i,
                       self._stream)
        if err != 0:
            raise RuntimeError(f"lanczos_step kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1

