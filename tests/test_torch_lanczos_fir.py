"""Port parity for the fused Lanczos+FIR step.

On the CPU, litcoder_core_torch's lanczos_fir is its plain version (the
CUDA kernel runs only on the card, where chip_smoke.py holds it against
this same plain version). It must match the JAX package's lanczos_fir (the
Pallas kernel in interpret mode, or the XLA formulation past its VMEM
budget) within 1e-4, the bar the TPU kernel met against the two-stage path,
and lanczos_fir_xla, the formulation it ports, within 1e-5."""

import re
import shutil
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
from litcoder_core_torch.ops.interp import lanczos_cutoff, lanczos_matrix

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


# Band skip: (label, word times, TR times) on which the kernel's tile
# predicate is checked. The main shape is chip_smoke.py's (1600 words over
# 640 s, 320 TRs of 2 s).
def _skip_cases():
    rng = np.random.default_rng(21)
    span = 640.0
    dt = np.sort(rng.uniform(0, span, 1600)).astype(np.float32)
    tt = (np.arange(320, dtype=np.float32) * 2.0 + 1.0).astype(np.float32)
    gap = np.sort(rng.uniform(0, span - 60.0, 1600)).astype(np.float32)
    gap[gap >= (span - 60.0) / 2] += np.float32(60.0)
    cases = [
        ("sorted", dt, tt),
        ("unsorted", dt[rng.permutation(1600)], tt),
        ("gapped", gap, tt),
        ("descending-tr", dt, tt[::-1].copy()),
        ("one-tr", dt[:100], np.array([31.0], np.float32)),
    ]
    for t_w, _, t_tr, _, sp in SHAPES:
        _, sdt, stt = _case(13, t_w, 1, t_tr, sp)
        cases.append((f"shape-{t_w}-{t_tr}", sdt, stt))
    return cases


SKIP_CASES = _skip_cases()


@pytest.mark.parametrize("case", SKIP_CASES, ids=lambda c: c[0])
def test_live_word_tiles_cover_every_weight(case):
    """Every nonzero or NaN Lanczos weight lies in a tile the kernel
    visits, at the kernel's tile sizes."""
    _, dt, tt = case
    dt, tt = torch.from_numpy(dt), torch.from_numpy(tt)
    live = lf.live_word_tiles(dt, tt)
    n_tr_tiles = -(-tt.shape[0] // lf.TILE_ROWS)
    n_word_tiles = -(-dt.shape[0] // lf.TILE_WORDS)
    assert live.shape == (n_tr_tiles, n_word_tiles)
    K = lanczos_matrix(dt, tt)
    rows, cols = torch.nonzero((K != 0) | torch.isnan(K), as_tuple=True)
    assert rows.numel() > 0
    assert bool(live[rows // lf.TILE_ROWS, cols // lf.TILE_WORDS].all())


def test_live_word_tiles_skip_the_band_complement():
    """Sorted times visit only the band; a silent gap leaves TR tiles with
    no word tile; one TR (NaN cutoff) leaves every tile live; unsorted
    times stay exact but visit more."""
    live = {label: lf.live_word_tiles(torch.from_numpy(dt),
                                      torch.from_numpy(tt))
            for label, dt, tt in SKIP_CASES}
    sorted_frac = live["sorted"].float().mean().item()
    assert 0 < sorted_frac < 0.1
    assert live["descending-tr"].sum() == live["sorted"].sum()
    assert (live["gapped"].sum(dim=1) == 0).any()
    assert not (live["sorted"].sum(dim=1) == 0).any()
    assert bool(live["one-tr"].all())
    assert live["unsorted"].sum() > 5 * live["sorted"].sum()


def test_live_word_tiles_other_tile_sizes():
    _, dt, tt = SKIP_CASES[0]
    dt, tt = torch.from_numpy(dt), torch.from_numpy(tt)
    K = lanczos_matrix(dt, tt, window=2, cutoff_mult=0.5)
    rows, cols = torch.nonzero(K != 0, as_tuple=True)
    for tile_rows, tile_words in ((1, 1), (3, 7), (16, 64)):
        live = lf.live_word_tiles(dt, tt, tile_rows, tile_words, window=2,
                                  cutoff_mult=0.5)
        assert bool(live[rows // tile_rows, cols // tile_words].all())
    exact = lf.live_word_tiles(dt, tt, 1, 1, window=2, cutoff_mult=0.5)
    assert torch.equal(exact, (torch.abs(
        (tt[:, None] - dt[None, :]) * (0.5 / torch.diff(tt).mean())) <= 2))


def test_tile_sizes_match_the_cuda_source():
    text = (REPO / "litcoder_core_torch" / "csrc" / "lanczos_fir.cu"
            ).read_text()
    assert re.search(rf"constexpr int kRows = {lf.TILE_ROWS};", text)
    assert re.search(rf"constexpr int kTileW = {lf.TILE_WORDS};", text)
    assert "__ballot_sync" in text and "word_is_live" in text


def test_library_key_follows_every_csrc_file(tmp_path, monkeypatch):
    """An edited header beside the source gives a new library name, so a
    stale library is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(REPO / "litcoder_core_torch" / "csrc", csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    key0 = cuda_build.library_path("lanczos_fir")
    assert cuda_build.library_path("lanczos_fir") == key0
    header = csrc / "tiles.cuh"
    header.write_text("#pragma once\nconstexpr int kA = 1;\n")
    key1 = cuda_build.library_path("lanczos_fir")
    header.write_text("#pragma once\nconstexpr int kA = 2;\n")
    key2 = cuda_build.library_path("lanczos_fir")
    (csrc / "lanczos_fir.cu").write_text(
        (csrc / "lanczos_fir.cu").read_text() + "\n")
    key3 = cuda_build.library_path("lanczos_fir")
    (csrc / "notes.txt").write_text("not a source")
    assert len({key0, key1, key2, key3}) == 4
    assert cuda_build.library_path("lanczos_fir") == key3
    assert key0.parent == cuda_build.BUILD_DIR
    with pytest.raises(FileNotFoundError):
        cuda_build.library_path("no_such_kernel")


def _small_skip_case(kind):
    """Small inputs of the band-skip kinds: unsorted word times, a silent
    gap, descending TR times."""
    rng = np.random.default_rng(22)
    span = 200.0
    data = rng.normal(size=(400, 6)).astype(np.float32)
    dt = np.sort(rng.uniform(0, span, 400)).astype(np.float32)
    tt = (np.arange(100, dtype=np.float32) * 2.0 + 1.0).astype(np.float32)
    if kind == "unsorted":
        perm = rng.permutation(400)
        data, dt = data[perm], dt[perm]
    elif kind == "gapped":
        dt = np.sort(rng.uniform(0, span - 40.0, 400)).astype(np.float32)
        dt[dt >= (span - 40.0) / 2] += np.float32(40.0)
    elif kind == "descending-tr":
        tt = tt[::-1].copy()
    return data, dt, tt


@pytest.mark.parametrize("kind", ["unsorted", "gapped", "descending-tr"])
def test_cpu_matches_jax_on_band_skip_inputs(kind):
    data, dt, tt = _small_skip_case(kind)
    delays = (1, 2, -1)
    got = lf.lanczos_fir(data, dt, tt, delays, device="cpu").numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_fused(data, dt, tt, delays)), atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(lanczos_fir_xla(data, dt, tt, delays=delays)),
        atol=1e-5)


def test_chip_smoke_main_shape_cases():
    """The kernel shapes chip_smoke.py adds: the same rows permuted, a story
    with a silent gap, TR times reversed."""
    import chip_smoke

    cases = {label: (data, dt, tt) for label, data, dt, tt in
             chip_smoke.main_shape_cases(np.random.default_rng(0))}
    data, dt, tt = cases["main"]
    assert data.shape == (1600, 768) and tt.shape == (320,)
    assert np.all(np.diff(dt) >= 0)
    p_data, p_dt, p_tt = cases["main, word times permuted"]
    order = np.argsort(p_dt, kind="stable")
    np.testing.assert_array_equal(p_dt[order], dt)
    np.testing.assert_array_equal(p_data[order], data)
    np.testing.assert_array_equal(p_tt, tt)
    _, g_dt, _ = cases["main, 60 s silent gap"]
    gaps = np.diff(np.sort(g_dt))
    assert gaps.max() >= 60.0 and g_dt.max() <= 640.0
    _, _, d_tt = cases["main, descending TR times"]
    np.testing.assert_array_equal(d_tt, tt[::-1])
    assert float(lanczos_cutoff(torch.from_numpy(d_tt), 1.0)) < 0
