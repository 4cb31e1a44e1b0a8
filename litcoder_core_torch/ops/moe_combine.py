"""The weighted combine of a mixture of experts' routed rows.

After the routed experts' GEMMs (features/deepseek_v2.py), ys (N k, H)
holds each token's k expert rows in expert-sorted order. `moe_combine`
sums them back per token:

    out[t] = sum_{j = 0..k-1} weights[t, j] * float(ys[pos[t k + j]])

in float32, in slot order j = 0, 1, ... (each product rounded, then added),
returned in ys' dtype. `pos` (N k,) int32 is the inverse of the sort's
order (`inverse_order`): where slot (t, j) landed among the sorted rows.
`moe_combine_reference` is its plain version in torch ops. `moe_combine`
dispatches on the device: the plain version for a CPU tensor only, the
hand-written kernel in csrc/moe_combine.cu for a CUDA tensor, which takes
bf16 rows (it launches or raises; nothing falls back).

`launches` counts kernel launches, so a run can show that its combines
went through the kernel.
"""

import ctypes

import torch

launches = 0

_KERNEL = "moe_combine"


def inverse_order(order: torch.Tensor) -> torch.Tensor:
    """pos (R,) int32 with pos[order[s]] = s: one scatter on the device of a
    permutation `order` of 0..R - 1, no wait for it."""
    count = order.numel()
    pos = torch.empty(count, dtype=torch.int32, device=order.device)
    return pos.scatter_(0, order, torch.arange(count, dtype=torch.int32,
                                               device=order.device))


def moe_combine_reference(ys: torch.Tensor, pos: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """The combine in torch ops: each token's rows gathered and upcast,
    then multiplied and added slot by slot in float32."""
    n, k = weights.shape
    rows = ys[pos].float().view(n, k, ys.shape[1])
    out = rows[:, 0] * weights[:, 0, None]
    for j in range(1, k):
        out = out + rows[:, j] * weights[:, j, None]
    return out.to(ys.dtype)


def build():
    """Build (or load) the kernel's library; returns (C entry point, build
    report). The entry point's argument types are declared here, so ctypes
    passes pointers and the stream as 64-bit values."""
    from litcoder_core_torch.ops import cuda_build

    lib, report = cuda_build.load(_KERNEL)
    fn = lib.moe_combine_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn, report


def _check(ys, pos, weights) -> None:
    """What the kernel takes: ys (R, H) bf16 with H a multiple of 8 and
    16-byte aligned rows, pos (R,) int32, weights (N, k) float32 with
    N k = R, all contiguous on ys' device."""
    if ys.dtype != torch.bfloat16:
        raise ValueError(f"the moe_combine kernel takes bfloat16 rows, not "
                         f"{ys.dtype}")
    if ys.ndim != 2 or ys.shape[1] % 8 != 0:
        raise ValueError(f"ys must be (rows, H) with H a multiple of 8 (one "
                         f"16-byte load of 8 lanes); got {tuple(ys.shape)}")
    if weights.ndim != 2 or weights.shape[0] * weights.shape[1] != \
            ys.shape[0]:
        raise ValueError(f"weights must be (N, k) with N k = {ys.shape[0]} "
                         f"rows; got {tuple(weights.shape)}")
    for name, t, dtype, shape in (
            ("ys", ys, torch.bfloat16, tuple(ys.shape)),
            ("pos", pos, torch.int32, (ys.shape[0],)),
            ("weights", weights, torch.float32, tuple(weights.shape))):
        if t.device != ys.device or t.dtype != dtype or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor of shape "
                f"{shape} on {ys.device}; got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}{'' if t.is_contiguous() else ', strided'}")
    if ys.data_ptr() % 16 != 0:
        raise ValueError("ys must start on a 16-byte boundary")


def moe_combine(ys: torch.Tensor, pos: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """(N, H) in ys' dtype: the plain version on the CPU, the kernel on a
    CUDA device (bf16 only; it launches on the current stream and does not
    synchronise), a refusal anywhere else."""
    global launches
    if ys.device.type == "cpu":
        return moe_combine_reference(ys, pos, weights)
    if ys.device.type != "cuda":
        raise ValueError(f"the combine runs on the CPU or a CUDA device, not "
                         f"{ys.device.type!r}")
    _check(ys, pos, weights)
    n, k = weights.shape
    out = torch.empty((n, ys.shape[1]), dtype=ys.dtype, device=ys.device)
    if n == 0:
        return out
    fn, _ = build()
    err = fn(ys.data_ptr(), pos.data_ptr(), weights.data_ptr(),
             out.data_ptr(), n, k, ys.shape[1],
             torch.cuda.current_stream(ys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_combine kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
