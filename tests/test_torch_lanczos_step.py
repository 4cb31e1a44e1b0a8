"""The Lanczos step of models/ridge.py's lambda-max (ops/lanczos_step.py).

On the CPU the recurrence runs the plain step, which must give, bit for
bit, what the recurrence written as one loop of torch ops gives
(`_unfused_lmax`, below) on the problems of tests/test_torch_ridge.py, for
all three operators. The CUDA kernel (csrc/lanczos_step.cu) runs only on
a card: the tests marked `card` hold it against the plain step there and
skip here. This file imports no JAX, so the card's machine runs it:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_lanczos_step.py
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from litcoder_core_torch.models import ridge as tr
from litcoder_core_torch.models.folding import create_folds
from litcoder_core_torch.ops import cuda_build
from litcoder_core_torch.ops import lanczos_step as ls
from litcoder_core_torch.utils import profiling
from litcoder_core_torch.utils.device import matmul_tf32

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _unfused_lmax(matvec, v0, m, bound, counts=None):
    """The recurrence as one loop of torch ops, with models/ridge.py's Ritz
    value and leading-block search: (lmax, diag, off); `counts` gets
    `fallback`, 1 where that search ran."""
    n = v0.shape[0]
    m = min(m, n)
    dev = v0.device
    v = v0 / torch.clamp(torch.linalg.norm(v0), min=1e-30)
    basis = torch.zeros((m, n), dtype=torch.float32, device=dev)
    diag = torch.zeros(m, dtype=torch.float32, device=dev)
    off = torch.zeros(m, dtype=torch.float32, device=dev)
    v_prev = torch.zeros_like(v)
    b_prev = torch.zeros((), dtype=torch.float32, device=dev)
    scale = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(m):
        w = matvec(v)
        a = torch.dot(w, v)
        w = w - a * v - b_prev * v_prev
        w = w - basis.T @ (basis @ w)
        b = torch.linalg.norm(w)
        scale = torch.maximum(scale, torch.abs(a))
        alive = b > 1e-6 * torch.clamp(scale, min=1.0)
        v_next = torch.where(alive, w / torch.clamp(b, min=1e-30), 0.0)
        b = torch.where(alive, b, 0.0)
        basis[i] = v
        diag[i] = a
        off[i] = b
        v_prev, v, b_prev = v, v_next, b

    def ritz_max(k):
        tri = (torch.diag(diag[:k]) + torch.diag(off[:k - 1], 1)
               + torch.diag(off[:k - 1], -1))
        return torch.linalg.eigvalsh(tri)[-1]

    def in_range(theta):
        return bool(torch.isfinite(theta) & (theta <= bound))

    def result():
        if bool(torch.isfinite(diag).all() & torch.isfinite(off).all()):
            lmax = ritz_max(m)
            if in_range(lmax):
                return lmax
        if counts is not None:
            counts["fallback"] = 1
        finite = torch.isfinite(diag) & torch.isfinite(off)
        k = int(torch.cumprod(finite.to(torch.int32), 0).sum())
        k = min(k + 1, m) if k < m and bool(torch.isfinite(diag[k])) else k
        for size in range(k, 0, -1):
            lmax = ritz_max(size)
            if in_range(lmax):
                return lmax
        return torch.clamp(diag[0], max=bound)

    if counts is not None:
        counts["fallback"] = 0
    return result(), diag, off


def _psd(D, rank):
    """tests/test_torch_ridge.py's random PSD Gram."""
    rng = np.random.default_rng(D + rank)
    A = rng.normal(size=(200, rank)) @ rng.normal(size=(rank, D))
    return torch.as_tensor((A.T @ A).astype(np.float32))


def _missed_breakdown_kernel():
    """Fold 0's 320 x 320 kernel of tests/test_torch_ridge.py's ROADMAP C
    problem (X = 3 X + 2, X normal (400, 30) from seed 13, chunked folds of
    20 rows from seed 0), where the f32 breakdown test misses the spent
    Krylov space."""
    X = np.random.default_rng(13).normal(size=(400, 30)).astype(np.float32)
    X = torch.as_tensor(X * 3.0 + 2.0)
    tr_idx, _ = create_folds(400, "chunked", 5, 20, seed=0)[0]
    Xtr = X[torch.as_tensor(tr_idx)]
    return Xtr @ Xtr.T


def _dense_cases():
    cases = [(f"psd-{D}-rank{r}", _psd(D, r))
             for D, r in [(30, 30), (30, 12), (3, 3)]]
    cases.append(("missed-breakdown", _missed_breakdown_kernel()))
    for n in (1, 4, 40):
        cases.append((f"constant-{n}", torch.full((n, n), 2.5)))
        cases.append((f"diagonal-{n}",
                      torch.diag(torch.linspace(1.0, 9.0, n))))
    return cases


DENSE = _dense_cases()


def _dense_operator(G):
    """(matvec, v0, bound) of ridge.lmax_dense."""
    v0 = G @ torch.ones(G.shape[0], dtype=torch.float32, device=G.device)
    return (lambda w: G @ w), v0, tr._gershgorin_bound(G)


def _low_rank_problem(n=40, rows=7, seed=5, device="cpu"):
    """(lam, P): the union Gram's eigenvalues and rows in its eigenbasis,
    as parallel/step.py hands them to lmax_downdate and lmax_update."""
    rng = np.random.default_rng(seed)
    lam = np.sort(rng.uniform(1.0, 50.0, n)).astype(np.float32)
    P = (rng.normal(size=(rows, n)) * 0.5).astype(np.float32)
    return (torch.as_tensor(lam, device=device),
            torch.as_tensor(P, device=device))


def _low_rank_operators(lam, P):
    """(name, lmax function, matvec, v0, bound, m) of lmax_downdate and
    lmax_update, as models/ridge.py builds them."""
    v0 = tr._top_basis_vector(lam)
    down = (lambda w: lam * w - P.T @ (P @ w))
    up = (lambda w: lam * w + P.T @ (P @ w))
    return [
        ("downdate", tr.lmax_downdate, down, v0,
         torch.max(lam) * (1.0 + 1e-4), 24),
        ("update", tr.lmax_update, up, v0,
         (torch.max(lam) + torch.sum(P * P)) * (1.0 + 1e-4), 24),
    ]


def _spans(call):
    """(call's result, the counts of its litcoder.fit.lmax spans) under a
    torch profiler."""
    profiling.clear_spans()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        out = call()
    counts = [s["counts"] for s in profiling.spans()
              if s["name"] == "litcoder.fit.lmax"]
    profiling.clear_spans()
    return out, counts


# --- on the CPU: the plain step ---------------------------------------------


@pytest.mark.parametrize("case", DENSE, ids=[c[0] for c in DENSE])
def test_plain_steps_match_the_unfused_loop_bit_for_bit(case):
    G = case[1]
    matvec, v0, bound = _dense_operator(G)
    want, want_diag, want_off = _unfused_lmax(matvec, v0, 64, bound)
    diag, off, fused = tr._lanczos_tridiagonal(matvec, v0,
                                               min(64, G.shape[0]))
    assert fused == 0
    assert torch.equal(diag, want_diag)
    assert torch.equal(off, want_off)
    got = tr.lmax_dense(G)
    assert torch.equal(got, want), (float(got), float(want))


@pytest.mark.parametrize("which", ["downdate", "update"])
def test_plain_steps_match_the_unfused_loop_for_the_low_rank_operators(
        which):
    lam, P = _low_rank_problem()
    for name, lmax, matvec, v0, bound, m in _low_rank_operators(lam, P):
        if name != which:
            continue
        want, want_diag, want_off = _unfused_lmax(matvec, v0, m, bound)
        diag, off, _ = tr._lanczos_tridiagonal(matvec, v0, m)
        assert torch.equal(diag, want_diag)
        assert torch.equal(off, want_off)
        assert torch.equal(lmax(lam, P), want)


def _poisoned(matvec, after):
    """matvec for `after` calls, then all NaN."""
    calls = []

    def poisoned(w):
        calls.append(1)
        out = matvec(w)
        return out if len(calls) <= after else torch.full_like(out, np.nan)

    return poisoned


def test_plain_steps_keep_nan_and_the_fallback_fires():
    G = _psd(30, 30)
    matvec, v0, bound = _dense_operator(G)
    want, want_diag, want_off = _unfused_lmax(_poisoned(matvec, 10), v0, 64,
                                              bound)
    counts = {}
    got = tr._lanczos_lmax(_poisoned(matvec, 10), v0, 64, bound, counts)
    assert counts == {"steps": 30, "fallback": 1, "fused": 0}
    diag, off, _ = tr._lanczos_tridiagonal(_poisoned(matvec, 10), v0, 30)
    assert torch.equal(diag[:10], want_diag[:10])
    assert torch.isnan(diag[10:]).all() and not off[10:].any()
    assert torch.equal(got, want) and float(got) <= float(bound)


def test_the_missed_breakdown_case_is_the_roadmap_c_kernel():
    K = _missed_breakdown_kernel()
    assert K.shape == (320, 320)
    assert abs(float(torch.linalg.eigvalsh(K.double())[-1]) - 41924.7) < 0.1


def test_plain_step_writes_in_place_and_reads_w_only():
    """One step by hand: basis[i] = v, diag[i] = a, off[i] = b, v_prev holds
    the next vector, state (b, scale); w is untouched."""
    G = _psd(30, 30)
    n = G.shape[0]
    v = torch.ones(n) / n ** 0.5
    v_prev = torch.zeros(n)
    basis, diag, off = torch.zeros((5, n)), torch.zeros(5), torch.zeros(5)
    state = torch.zeros(2)
    w = G @ v
    w0 = w.clone()
    ls.lanczos_step_reference(w, v, v_prev, basis, diag, off, state, 0)
    assert torch.equal(w, w0)
    a = torch.dot(w0, v)
    r = w0 - a * v
    assert torch.equal(basis[0], v) and not basis[1:].any()
    assert diag[0] == a and state[1] == abs(a)
    assert torch.allclose(off[0], torch.linalg.norm(r))
    assert state[0] == off[0]
    torch.testing.assert_close(v_prev, r / torch.linalg.norm(r))


def test_span_counts_no_fused_steps_on_the_cpu():
    lam, P = _low_rank_problem()
    _, counts = _spans(lambda: (tr.lmax_dense(_psd(30, 12)),
                                tr.lmax_downdate(lam, P),
                                tr.lmax_update(lam, P)))
    assert counts == [{"steps": 30, "fallback": 0, "fused": 0},
                      {"steps": 24, "fallback": 0, "fused": 0},
                      {"steps": 24, "fallback": 0, "fused": 0}]


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel's operand check refuses CPU buffers, and a recurrence whose
    vector is off the CPU raises rather than take the plain step on the CPU
    buffers beside it."""
    n = 8
    bufs = (torch.zeros(n), torch.zeros(n), torch.zeros((4, n)),
            torch.zeros(4), torch.zeros(4), torch.zeros(2))
    before = ls.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ls._check_operands(*bufs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ls.LanczosSteps(torch.zeros(n, device="meta"), *bufs[1:])
    assert ls.launches == before


def test_cuda_request_raises_without_a_card():
    """Tensors off the CPU never take the plain step: without a card (meta
    tensors stand in) the recurrence raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the card tests cover it")
    before = ls.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tr.lmax_dense(torch.eye(8, device="meta"))
    lam = torch.ones(8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tr._lanczos_tridiagonal(lambda w: lam * w, lam, 4)
    assert ls.launches == before


def test_wrapper_checks_the_kernels_limits():
    with pytest.raises(ValueError, match="steps"):
        ls.LanczosSteps(torch.zeros(4, device="meta"),
                          torch.zeros(4, device="meta"),
                          torch.zeros((5, 4), device="meta"),
                          torch.zeros(5, device="meta"),
                          torch.zeros(5, device="meta"),
                          torch.zeros(2, device="meta"))


def test_cuda_source_and_build_command():
    src = REPO / "litcoder_core_torch" / "csrc" / "lanczos_step.cu"
    text = src.read_text()
    assert 'extern "C" int lanczos_step_launch' in text
    assert "litcoder_core_tpu/models/ridge.py" in text  # the loop it fuses
    limit = re.search(r"constexpr int kMaxSteps = (\d+);", text)
    assert limit and int(limit.group(1)) == ls.MAX_STEPS
    cmd = cuda_build.nvcc_command("nvcc", src, Path("/x/lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--use_fast_math" not in cmd and "-use_fast_math" not in cmd
    assert cmd[-1] == str(src)
    path = cuda_build.library_path("lanczos_step")
    assert path.parent == REPO / "litcoder_core_torch" / "_build"
    assert path.name.startswith("lanczos_step-")
    assert path != cuda_build.library_path("lanczos_fir")


def test_module_imports_without_nvcc():
    code = (
        "import sys, litcoder_core_torch.models.ridge\n"
        "import litcoder_core_torch.ops.lanczos_step as m\n"
        "assert 'triton' not in sys.modules\n"
        "assert m.launches == 0\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PATH": "/nonexistent", "PYTHONPATH": str(REPO),
                              "HOME": os.environ.get("HOME", "/")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_step_check_and_launch_record():
    """chip_smoke.py's step-by-step check, run on CPU tensors, holds the
    plain step against itself (gap 0); its launch record files each
    phase's count under the phase's number."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    G = _psd(30, 30)
    assert chip_smoke.check_step_kernel(G, 20) == 0.0
    record = chip_smoke.StepLaunches()
    record.begin("3 kernel vs plain on the card")
    ls.launches += 5
    record.begin("4 small end-to-end parity")
    record.end()
    assert record.by_phase == {"3": 5, "4": 0}


# --- on the card: the kernel against the plain step -------------------------


def _well_conditioned(n, seed=0):
    """A random PSD matrix with a spread spectrum: A^T A / (3 n), A (3n, n)."""
    rng = np.random.default_rng(seed + n)
    A = rng.normal(size=(3 * n, n)).astype(np.float32)
    return torch.as_tensor(A.T @ A / (3.0 * n))


CARD_SIZES = [1, 4, 40, 488, 1424, 1425, 3072]


@pytest.mark.card
@pytest.mark.parametrize("n", CARD_SIZES)
def test_kernel_steps_match_the_plain_step(n, card):
    """Each step from the same inputs (chip_smoke.check_step_kernel, the
    check phase 3 runs at n 1,424 and 3,072): the basis rows exactly; a, b
    and b v_next (the residual) within 1e-5 of the step's scale (fp32 sums
    of at most 3,072 terms in another order); then both go on from the
    plain step's state. n 1,425 splits unevenly over the kernel's 8
    blocks, n 1 and 4 leave some empty; n 1, 4 and 40 run m = n. The whole
    recurrence's lmax agrees within 1e-5."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    G = _well_conditioned(n).to(card)
    with matmul_tf32(False):
        assert chip_smoke.STEP_RTOL == 1e-5
        assert chip_smoke.check_step_kernel(G, min(64, n)) <= 1e-5
        v0 = G @ torch.ones(n, device=card)
        want = _unfused_lmax(lambda x: G @ x, v0, 64,
                             tr._gershgorin_bound(G))[0]
        got = tr.lmax_dense(G)
    torch.cuda.synchronize()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.card
def test_kernel_reruns_give_the_same_bits(card):
    G = _well_conditioned(1424).to(card)
    with matmul_tf32(False):
        first = tr._lanczos_tridiagonal(lambda w: G @ w, G.sum(dim=1), 64)
        again = tr._lanczos_tridiagonal(lambda w: G @ w, G.sum(dim=1), 64)
    assert first[2] == again[2] == 64
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def _first_zero(off):
    """Index of the first exact zero in off, None where there is none."""
    zeros = torch.nonzero(off == 0)
    return int(zeros[0, 0]) if len(zeros) else None


@pytest.mark.card
def test_kernel_on_the_missed_breakdown_kernel(card):
    """The missed-breakdown kernel on the card: every step runs in the
    kernel, and either the fallback searched the leading blocks or the
    breakdown test caught the spent Krylov space (an exact zero in off).
    The plain loop on the card does the same: the same fallback and its
    first zero in off at the same step. lmax agrees with the CPU's, the
    card's plain loop's and float64's within 1e-4."""
    K = _missed_breakdown_kernel()
    want = float(torch.linalg.eigvalsh(K.double())[-1])
    plain = float(tr.lmax_dense(K))
    plain_counts = {}
    with matmul_tf32(False):
        got, counts = _spans(lambda: tr.lmax_dense(K.to(card)))
        matvec, v0, bound = _dense_operator(K.to(card))
        _, off, _ = tr._lanczos_tridiagonal(matvec, v0, 64)
        plain_card, _, plain_off = _unfused_lmax(matvec, v0, 64, bound,
                                                 plain_counts)
    assert counts[0]["steps"] == counts[0]["fused"] == 64, counts
    assert counts[0]["fallback"] == 1 or bool((off == 0).any()), counts
    assert counts[0]["fallback"] == plain_counts["fallback"], (
        counts, plain_counts)
    assert _first_zero(off) == _first_zero(plain_off), (
        _first_zero(off), _first_zero(plain_off))
    assert np.isfinite(float(got))
    assert abs(float(got) - plain) <= 1e-4 * want
    assert abs(float(got) - float(plain_card)) <= 1e-4 * want
    assert abs(float(got) - want) <= 1e-4 * want


@pytest.mark.card
def test_kernel_keeps_nan_as_the_plain_step_and_falls_back(card):
    """An operator that turns NaN after 10 steps: the kernel writes NaN
    diagonals and zero betas where the plain step on the card does, and the
    fallback returns the same leading block's Ritz value."""
    G = _well_conditioned(488).to(card)
    with matmul_tf32(False):
        matvec, v0, bound = _dense_operator(G)
        want, want_diag, want_off = _unfused_lmax(_poisoned(matvec, 10), v0,
                                                  64, bound)
        counts = {}
        got = tr._lanczos_lmax(_poisoned(matvec, 10), v0, 64, bound, counts)
        diag, off, fused = tr._lanczos_tridiagonal(_poisoned(matvec, 10),
                                                   v0, 64)
    assert fused == 64
    assert counts == {"steps": 64, "fallback": 1, "fused": 64}
    assert torch.equal(torch.isnan(diag), torch.isnan(want_diag))
    assert torch.isnan(diag[10:]).all() and not off[10:].any()
    assert torch.equal(off == 0, want_off == 0)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.card
def test_all_three_operators_run_the_kernel(card):
    """lmax_dense, lmax_downdate and lmax_update on the card: every step is
    a launch, the span counts fused == steps, and each lmax agrees within
    1e-5 with the plain recurrence on the card."""
    G = _well_conditioned(488).to(card)
    lam, P = _low_rank_problem(n=488, rows=40, device=card)
    calls = [(tr.lmax_dense, (G,), _dense_operator(G) + (64,))]
    calls += [(lmax, (lam, P), (matvec, v0, bound, m)) for _, lmax, matvec,
              v0, bound, m in _low_rank_operators(lam, P)]
    with matmul_tf32(False):
        for fn, args, (matvec, v0, bound, m) in calls:
            want = float(_unfused_lmax(matvec, v0, m, bound)[0])
            before = ls.launches
            got, counts = _spans(lambda: fn(*args))
            assert ls.launches - before == m
            assert counts == [{"steps": m, "fallback": 0, "fused": m}]
            assert abs(float(got) - want) <= 1e-5 * abs(want), (
                fn.__name__, float(got), want)
