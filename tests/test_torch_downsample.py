"""Port parity for the ten downsampling methods, their segment and
interpolation ops, the trainer's two-stage path with them, and the assembly
loader: the port on the CPU against the JAX package on the same seeded
numpy inputs. Bar: within 1e-5 of the reference's largest magnitude, with
the same shapes."""

import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import litcoder_core_tpu as J
import litcoder_core_torch as T
from litcoder_core_torch.assembly.convert import assembly_from_reference
from litcoder_core_torch.ops import interp as tinterp
from litcoder_core_torch.ops import segment as tseg
from litcoder_core_tpu.ops import interp as jinterp
from litcoder_core_tpu.ops import segment as jseg
from tests.test_torch_trainer import (  # noqa: F401 (fixtures)
    FIT,
    _trainer,
    jax_assembly,
    kv_path,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
GABOR = {"freqs": [0.1, 0.2, 0.3], "sigma": 2.0}
METHOD_KWARGS = {
    "rect": {},
    "lanczos": {"window": 3, "cutoff_mult": 1.0},
    "sinc": {"window": 3, "cutoff_mult": 1.0, "causal": False},
    "gabor": GABOR,
    "average": {}, "sum": {}, "last": {},
    "legacy_average": {}, "legacy_sum": {}, "legacy_last": {},
}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def story():
    """(data, word times, TR times, per-word TR ids, legacy boundaries) of
    one 230-word story over 49 TRs of 2 s; the last TRs hear no word."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(230, 7)).astype(np.float32)
    dt = np.sort(rng.uniform(0, 90, 230)).astype(np.float32)
    tt = (np.arange(49) * 2.0 + 1.0).astype(np.float32)
    split = (dt // 2).astype(int)
    boundaries = np.flatnonzero(np.diff(split)) + 1
    return data, dt, tt, split, boundaries


@pytest.mark.parametrize("method", list(METHOD_KWARGS))
def test_method_matches_jax(story, method):
    data, dt, tt, split, boundaries = story
    kw = dict(METHOD_KWARGS[method])
    if method in ("average", "sum", "last"):
        kw["split_indices"] = split
    elif method.startswith("legacy"):
        kw["split_indices"] = boundaries
    want = J.Downsampler().downsample(data, dt, tt, method=method, **kw)
    got = T.Downsampler().downsample(data, dt, tt, method=method,
                                     device="cpu", **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _close(got, want)
    if method in ("average", "sum", "last"):
        assert got.shape[0] == len(tt) > split.max() + 1


def test_default_method_is_rect(story):
    data, dt, tt, _, _ = story
    got = T.Downsampler().downsample(data, dt, tt, device="cpu")
    _close(got, J.Downsampler().downsample(data, dt, tt))
    _close(got, T.Downsampler().downsample(data, dt, tt, method="rect",
                                           device="cpu"))


def test_facade_tables_match_jax():
    t, j = T.Downsampler(), J.Downsampler()
    assert t.available_methods == j.available_methods
    assert t.METHOD_PARAMS == j.METHOD_PARAMS
    for m in j.available_methods:
        assert t.get_method_params(m) == j.get_method_params(m)
    with pytest.raises(ValueError, match="Unsupported"):
        t.get_method_params("nope")


@pytest.mark.parametrize("method,kw,match", [
    ("nope", {}, "Unsupported downsampling method"),
    ("average", {}, "Required parameter 'split_indices'"),
    ("sinc", {"window": 3}, "Required parameter 'cutoff_mult'"),
    ("gabor", {"freqs": [0.1]}, "Required parameter 'sigma'"),
    ("average", {"split_indices": None}, "split_indices must be provided"),
    ("legacy_sum", {"split_indices": None}, "Legacy downsampling"),
])
def test_parameter_validation_matches_jax(method, kw, match):
    args = (np.zeros((5, 2)), None, None)
    with pytest.raises(ValueError, match=match):
        J.Downsampler().downsample(*args, method=method, **kw)
    with pytest.raises(ValueError, match=match):
        T.Downsampler().downsample(*args, method=method, device="cpu", **kw)


def test_trailing_wordless_trs():
    data = np.random.default_rng(1).normal(size=(8, 3)).astype(np.float32)
    split = [0, 0, 1, 2, 2, 3, 5, 5]  # TRs 4, 6..9 hear no word
    tt = np.arange(10) * 2.0
    for method in ("average", "sum", "last"):
        out = T.Downsampler().downsample(data, None, tt, method=method,
                                         split_indices=split, device="cpu")
        _close(out, J.Downsampler().downsample(data, None, tt, method=method,
                                               split_indices=split))
        assert out.shape == (10, 3) and not out[6:].any() and not out[4].any()
        short = T.Downsampler().downsample(data, None, None, method=method,
                                           split_indices=split, device="cpu")
        assert short.shape == (6, 3)


def test_segment_ops_match_jax():
    rng = np.random.default_rng(2)
    data = rng.normal(size=(50, 4)).astype(np.float32)
    ids = np.sort(rng.integers(0, 12, 50))
    ids[ids == 5] = 6  # an empty segment in the middle
    for name in ("segment_sum_pool", "segment_mean_pool",
                 "segment_last_pool"):
        got = getattr(tseg, name)(torch.as_tensor(data), torch.as_tensor(ids),
                                  14)
        _close(got, getattr(jseg, name)(data, ids, 14))
    # Unsorted ids: 'last' is the row with the highest index.
    perm = rng.permutation(50)
    _close(tseg.segment_last_pool(torch.as_tensor(data),
                                  torch.as_tensor(ids[perm]), 14),
           jseg.segment_last_pool(data, ids[perm], 14))
    b = np.array([0, 3, 3, 10, 49, 50])
    np.testing.assert_array_equal(
        tseg.boundaries_to_segment_ids(50, torch.as_tensor(b)).numpy(),
        np.asarray(jseg.boundaries_to_segment_ids(50, b)))
    dt = np.sort(rng.uniform(0, 40, 50)).astype(np.float32)
    tt = np.arange(1.0, 60.0, 2.0, dtype=np.float32)  # empty windows past 41
    _close(tseg.rect_pool(*map(torch.as_tensor, (data, dt, tt))),
           jseg.rect_pool(data, dt, tt))


def test_interp_ops_match_jax():
    rng = np.random.default_rng(3)
    t = rng.uniform(-4, 4, (6, 30)).astype(np.float32)
    t[0, 3] = 0.0  # the +1e-20 denominator: 0 at t == 0
    for kw in ({}, {"window": 2, "causal": True},
               {"window": 0.1, "renorm": True}, {"renorm": False}):
        got = tinterp.sincfun(0.4, torch.as_tensor(t), **kw)
        _close(got, jinterp.sincfun(0.4, t, **kw))
    assert float(tinterp.sincfun(0.4, torch.zeros(1, 1), renorm=False)) == 0
    data = rng.normal(size=(40, 3)).astype(np.float32)
    old = np.sort(rng.uniform(0, 20, 40)).astype(np.float32)
    old[5] = old[4]  # coinciding old times
    new = np.linspace(-3, 24, 55).astype(np.float32)  # beyond both ends
    _close(tinterp.interpdata(*map(torch.as_tensor, (data, old, new))),
           jinterp.interpdata(data, old, new))
    for causal in (False, True):
        _close(tinterp.sincinterp2D(*map(torch.as_tensor, (data, old, new)),
                                    window=3, causal=causal),
               jinterp.sincinterp2D(data, old, new, window=3, causal=causal))
    freqs = np.array([0.1, 0.25], np.float32)
    got = tinterp.gabor_xfm(torch.as_tensor(data[:, 0]), torch.as_tensor(old),
                            torch.as_tensor(new), torch.as_tensor(freqs), 1.5)
    want = jinterp.gabor_xfm(data[:, 0], old, new, freqs, 1.5)
    _close(got.real, want.real)
    _close(got.imag, want.imag)
    got = tinterp.gabor_xfm2D(torch.as_tensor(data.T), torch.as_tensor(old),
                              torch.as_tensor(new), torch.as_tensor(freqs),
                              1.5)
    want = jinterp.gabor_xfm2D(data.T, old, new, freqs, 1.5)
    assert got.shape == want.shape == (3 * 2, 55)
    _close(got.real, want.real)
    _close(got.imag, want.imag)


@pytest.mark.parametrize("config", [
    {"method": "average"},
    {"method": "sinc", "window": 3, "cutoff_mult": 1.0},
    {},
], ids=["average", "sinc", "no method (rect)"])
def test_two_stage_trainer_matches_jax(jax_assembly, kv_path, tmp_path,
                                       config):
    """The port's two-stage path with a non-Lanczos method against the JAX
    trainer: the same delayed features, alphas and scores."""
    jt = _trainer(J, jax_assembly, kv_path, tmp_path / "j",
                  downsample_config=dict(config))
    tt = _trainer(T, assembly_from_reference(jax_assembly), kv_path,
                  tmp_path / "t", downsample_config=dict(config))
    assert not tt._fused_eligible()
    want = jt.apply_fir_delays(jt.extract_and_downsample_features())
    got = tt.apply_fir_delays(tt.extract_and_downsample_features())
    for s in want:
        _close(got[s], want[s])
    mj, mt = jt.train(**FIT), tt.train(**FIT)
    assert mt["best_alphas"] == mj["best_alphas"]
    np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                               atol=2e-3)
    assert abs(mt["median_score"] - mj["median_score"]) <= 1e-3
    assert mt["solver_paths"] == mj["solver_paths"]
    assert "extract_and_downsample" in mt["trainer_stage_seconds"]


def _reference_path_pickle(asm, path):
    """Pickle `asm` under the original LITcoder module paths
    (encoding.assembly.*), as the reference package writes them."""
    fakes = {m: types.ModuleType(m) for m in ("encoding",
                                              "encoding.assembly")}
    classes = {}
    for mod, name in (("encoding.assembly.assemblies",
                       "SimpleNeuroidAssembly"),
                      ("encoding.assembly.story_data", "StoryData")):
        cls = type(name, (), {"__module__": mod})
        fakes[mod] = types.ModuleType(mod)
        setattr(fakes[mod], name, cls)
        classes[name] = cls

    def convert(obj, name):
        out = object.__new__(classes[name])
        out.__dict__.update(obj.__dict__)
        return out

    ref = convert(asm, "SimpleNeuroidAssembly")
    ref.story_data = {k: convert(v, "StoryData")
                      for k, v in asm.story_data.items()}
    saved = {m: sys.modules.get(m) for m in fakes}
    sys.modules.update(fakes)
    try:
        with open(path, "wb") as f:
            pickle.dump(ref, f)
    finally:
        for m, old in saved.items():
            if old is None:
                sys.modules.pop(m)
            else:
                sys.modules[m] = old


def test_load_assembly_reads_jax_and_reference_pickles(jax_assembly,
                                                       kv_path, tmp_path):
    """A JAX-package pickle and an encoding.assembly.* pickle load through
    the port's load_assembly, in a process that imports no JAX, into the
    port's classes; the JAX pickle then trains to the JAX trainer's metrics.
    """
    jax_pkl = tmp_path / "jax.pkl"
    ref_pkl = tmp_path / "ref.pkl"
    J.save_assembly(jax_assembly, str(jax_pkl))
    _reference_path_pickle(assembly_from_reference(jax_assembly), ref_pkl)
    code = (
        "import sys\n"
        "from litcoder_core_torch import load_assembly\n"
        "from litcoder_core_torch.assembly import StoryData,"
        " SimpleNeuroidAssembly\n"
        f"for p in ({str(jax_pkl)!r}, {str(ref_pkl)!r}):\n"
        "    a = load_assembly(p)\n"
        "    assert type(a) is SimpleNeuroidAssembly, type(a)\n"
        "    assert all(type(s) is StoryData for s in a.story_data.values())\n"
        "    print(len(a.stories))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('litcoder_core_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(jax_assembly.stories))] * 2

    for path in (jax_pkl, ref_pkl):
        asm = T.load_assembly(str(path))
        assert asm.stories == jax_assembly.stories
        np.testing.assert_array_equal(asm.data, jax_assembly.data)
    asm = T.load_assembly(str(jax_pkl))
    mt = _trainer(T, asm, kv_path, tmp_path / "t").train(**FIT)
    mj = _trainer(J, jax_assembly, kv_path, tmp_path / "j").train(**FIT)
    assert mt["best_alphas"] == mj["best_alphas"]
    np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                               atol=2e-3)
    T.save_assembly(asm, str(tmp_path / "port.pkl"))
    back = J.load_assembly(str(tmp_path / "port.pkl"))
    assert back.stories == asm.stories


def test_load_assembly_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        T.load_assembly(str(tmp_path / "missing.pkl"))
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(b"not a pickle")
    with pytest.raises(T.assembly.AssemblyLoaderError):
        T.load_assembly(str(bad))
    empty = tmp_path / "empty.pkl"
    with open(empty, "wb") as f:
        pickle.dump(types.SimpleNamespace(stories=[], story_data={}), f)
    with pytest.raises(T.assembly.AssemblyLoaderError, match="validation"):
        T.load_assembly(str(empty))
