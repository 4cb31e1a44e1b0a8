"""Port parity for the fused Lanczos+FIR step.

On the CPU, litcoder_core_torch's lanczos_fir is its plain version (the
CUDA kernel runs only on the card, where chip_smoke.py holds it against
this same plain version). It must match the JAX package's lanczos_fir (the
Pallas kernel in interpret mode, or the XLA formulation past its VMEM
budget) within 1e-4, the bar the TPU kernel met against the two-stage path,
and lanczos_fir_xla, the formulation it ports, within 1e-5."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from litcoder_core_tpu.ops.pallas_kernels import lanczos_fir as jax_fused
from litcoder_core_tpu.ops.pallas_kernels import lanczos_fir_xla
from litcoder_core_torch.ops import cuda_build
from litcoder_core_torch.ops import lanczos_fir as lf

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

# (t_w, dim, t_tr, delays, span) — the shapes of tests/test_pallas_kernels.py
SHAPES = [
    (230, 17, 49, (1, 2, 3, 4), 100.0),
    (230, 5, 49, (0,), 100.0),
    (230, 5, 49, (-2, 0, 3), 100.0),
    (230, 300, 49, (1, 2), 100.0),
    (90, 7, 25, (0, 1, 2, -1), 60.0),
    (4600, 3, 512, (1, 2), 1000.0),
]


def _case(seed, t_w, dim, t_tr, span):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(t_w, dim)).astype(np.float32)
    dt = np.sort(rng.uniform(0, span, t_w)).astype(np.float32)
    tt = np.linspace(1.0, span - 1.0, t_tr).astype(np.float32)
    return data, dt, tt


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}-{s[2]}-{s[3]}")
def test_cpu_matches_jax_lanczos_fir(shape):
    t_w, dim, t_tr, delays, span = shape
    data, dt, tt = _case(13, t_w, dim, t_tr, span)
    got = lf.lanczos_fir(data, dt, tt, delays, device="cpu").numpy()
    assert got.shape == (t_tr, len(delays) * dim)
    np.testing.assert_allclose(
        got, np.asarray(jax_fused(data, dt, tt, delays)), atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(lanczos_fir_xla(data, dt, tt, delays=delays)),
        atol=1e-5)


def test_unsorted_word_times():
    """The kernel does not assume sorted word times; nor does the spec."""
    data, dt, tt = _case(14, 120, 4, 30, 80.0)
    perm = np.random.default_rng(0).permutation(120)
    got = lf.lanczos_fir(data[perm], dt[perm], tt, (1, 2), device="cpu")
    want = lf.lanczos_fir(data, dt, tt, (1, 2), device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    data, dt, tt = _case(15, 20, 2, 5, 10.0)
    before = lf.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        lf.lanczos_fir(data, dt, tt)  # default device is the card
    assert lf.launches == before


def test_cuda_wrapper_rejects_cpu_tensors():
    x = torch.zeros((4, 2))
    t = torch.arange(4, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lf.lanczos_fir_cuda(x, t, t)


def test_cuda_source_and_build_command():
    src = REPO / "litcoder_core_torch" / "csrc" / "lanczos_fir.cu"
    text = src.read_text()
    assert 'extern "C" int lanczos_fir_launch' in text
    assert "pallas_kernels.py" in text  # names the TPU kernel it replaces
    cmd = cuda_build.nvcc_command("nvcc", src, Path("/x/lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--use_fast_math" not in cmd and "-use_fast_math" not in cmd
    assert cuda_build.library_path("lanczos_fir").parent == \
        REPO / "litcoder_core_torch" / "_build"


def test_module_imports_without_triton_or_nvcc():
    code = (
        "import sys, litcoder_core_torch.ops.lanczos_fir as m\n"
        "assert 'triton' not in sys.modules\n"
        "assert m.launches == 0\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PATH": "/nonexistent", "PYTHONPATH": str(REPO)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
