"""Port parity for the voxel-sharded fits: fit_nested_cv, NestedCVModel
through the trainer, fit_banded_ridge, fit_stacked_ridge and the CLI's
--n_devices, each with a mesh of CPU entries, against the JAX package's
mesh fit on its 8 virtual CPU devices (the cases of tests/test_mesh_fit.py)
and against the port's own unsharded fit. Against JAX: the same alphas and
gammas and the same solver_paths, correlations within the bars of the
port's unsharded tests of the same function; against the unsharded port:
the same alphas, correlations within 1e-5. V=21 is not divisible by 8, so
the pad and its strip run."""

import logging

import numpy as np
import pytest
import torch

import litcoder_core_torch as T
import litcoder_core_tpu as J
from litcoder_core_torch import cli as tcli
from litcoder_core_torch.assembly.convert import assembly_from_reference
from litcoder_core_torch.models import banded as tb
from litcoder_core_torch.models import nested_cv as tcv
from litcoder_core_torch.models import stacking as ts
from litcoder_core_torch.parallel.mesh import make_mesh
from litcoder_core_tpu import cli as jcli
from litcoder_core_tpu.assembly.assemblies import SimpleNeuroidAssembly
from litcoder_core_tpu.assembly.assembly_loader import save_assembly
from litcoder_core_tpu.models import banded as jb
from litcoder_core_tpu.models import nested_cv as jcv
from litcoder_core_tpu.models import stacking as js
from litcoder_core_tpu.parallel.mesh import make_mesh as jmake_mesh
from tests.test_cli_banded import _banded_config
from tests.test_trainer_e2e import _make_story

torch.set_num_threads(2)

KW = dict(alphas=np.logspace(-1, 3, 5), chunk_length=10, n_inner_folds=4,
          seed=0)


def _problem(seed, T_=240, Tp=60, D=10, V=21, noise=0.5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T_, D)).astype(np.float32)
    wt = rng.normal(size=(D, V)).astype(np.float32)
    Y = (X @ wt + noise * rng.normal(size=(T_, V))).astype(np.float32)
    X_test = rng.normal(size=(Tp, D)).astype(np.float32)
    Y_test = (X_test @ wt + noise * rng.normal(size=(Tp, V))).astype(
        np.float32)
    return X, Y, X_test, Y_test


def _spaces(seed, T_=240, Tp=60, V=21, dims=(6, 4)):
    rng = np.random.default_rng(seed)
    Xs = [rng.normal(size=(T_, d)).astype(np.float32) for d in dims]
    Xts = [rng.normal(size=(Tp, d)).astype(np.float32) for d in dims]
    w = rng.normal(size=(dims[0], V)).astype(np.float32)
    Y = (Xs[0] @ w + 0.5 * rng.normal(size=(T_, V))).astype(np.float32)
    Yt = (Xts[0] @ w + 0.5 * rng.normal(size=(Tp, V))).astype(np.float32)
    return Xs, Y, Xts, Yt


def _assert_sharded(got, want, plain, atol=2e-3, median_atol=1e-3):
    """got: the port's mesh fit; want: JAX's mesh fit; plain: the port's
    unsharded fit (metrics dicts)."""
    assert got["solver_paths"] == want["solver_paths"]
    np.testing.assert_array_equal(got["best_alphas"], want["best_alphas"])
    np.testing.assert_allclose(got["correlations"], want["correlations"],
                               atol=atol)
    assert abs(got["median_score"] - want["median_score"]) <= median_atol
    assert got["n_significant"] == want["n_significant"]
    np.testing.assert_array_equal(got["best_alphas"], plain["best_alphas"])
    np.testing.assert_allclose(got["correlations"], plain["correlations"],
                               atol=1e-5)
    assert got["significant_mask"] == plain["significant_mask"]


# ---- fit_nested_cv ----------------------------------------------------------

def test_fit_train_test_mode_mesh_invariant(caplog):
    X, Y, Xt, Yt = _problem(1)
    want, wj, aj = jcv.fit_nested_cv(X, Y, X_test=Xt, y_test=Yt, n_devices=8,
                                     **KW)
    plain, wp, _ = tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu", **KW)
    with caplog.at_level(logging.INFO,
                         logger="litcoder_core_torch.models.nested_cv"):
        got, wt, at = tcv.fit_nested_cv(X, Y, Xt, Yt, n_devices=8,
                                        device="cpu", **KW)
    assert any("voxel-sharded fit: 21 voxels (+3 pad) over 8 devices"
               in r.message for r in caplog.records)
    _assert_sharded(got, want, plain)
    assert wt.shape == wj.shape == (X.shape[1], Y.shape[1])
    np.testing.assert_allclose(wt, wj, atol=1e-4 * np.abs(wj).max())
    np.testing.assert_allclose(wt, wp, atol=1e-5 * np.abs(wp).max())
    np.testing.assert_array_equal(at, aj)


@pytest.mark.parametrize("extra", [
    dict(method="eigh", return_weights=False),
    dict(fast_scan="auto", voxel_chunk_size=5),
    dict(single_alpha=True),
], ids=["eigh_no_weights", "fast_scan_auto_chunk_ignored", "single_alpha"])
def test_fit_train_test_mesh_object_and_routes(extra):
    """A prebuilt Mesh; the complement-eigh kernel, the guarded fast scan
    (its calibration voxels on the padded axis, as in JAX; the chunk is
    ignored under a mesh) and single_alpha's mean over the whole axis."""
    X, Y, Xt, Yt = _problem(2)
    kw = dict(KW, **extra)
    want, wj, _ = jcv.fit_nested_cv(X, Y, X_test=Xt, y_test=Yt,
                                    mesh=jmake_mesh(8), **kw)
    plain, _, _ = tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu", **kw)
    got, wt, _ = tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu",
                                   mesh=make_mesh(devices=["cpu"] * 8), **kw)
    _assert_sharded(got, want, plain)
    if extra.get("return_weights") is False:
        assert wt is None and wj is None


def test_fit_full_cv_mode_mesh_invariant():
    X, Y, _, _ = _problem(3, T_=300)
    kw = dict(KW, n_outer_folds=3, n_inner_folds=3)
    want, wj, aj = jcv.fit_nested_cv(X, Y, n_devices=8, **kw)
    plain, wp, ap = tcv.fit_nested_cv(X, Y, device="cpu", **kw)
    got, wt, at = tcv.fit_nested_cv(X, Y, n_devices=8, device="cpu", **kw)
    _assert_sharded(got, want, plain)
    assert got["solver_paths"]["mode"] == "full_cv_fused"
    assert (got["majority_significant_mask"]
            == want["majority_significant_mask"]
            == plain["majority_significant_mask"])
    assert wt.shape == wj.shape == wp.shape
    np.testing.assert_allclose(wt, wj, atol=1e-4 * np.abs(wj).max())
    np.testing.assert_allclose(at, aj)
    np.testing.assert_allclose(at, ap)


def test_fit_full_cv_per_fold_mesh_invariant():
    """The per-fold route (normalizers), shard by shard."""
    X, Y, _, _ = _problem(4, T_=300)
    kw = dict(KW, n_outer_folds=3, n_inner_folds=3, normalize_targets=True)
    want, _, _ = jcv.fit_nested_cv(X, Y, n_devices=8, **kw)
    plain, _, _ = tcv.fit_nested_cv(X, Y, device="cpu", **kw)
    got, _, _ = tcv.fit_nested_cv(X, Y, n_devices=8, device="cpu", **kw)
    assert got["solver_paths"]["mode"] == "full_cv_per_fold"
    _assert_sharded(got, want, plain)


def test_model_class_mesh_knob_through_trainer(tmp_path):
    """NestedCVModel(n_devices=8) through AbstractTrainer.train(), against
    JAX's trainer with NestedCVModel(n_devices=8) and the port's unsharded
    trainer, on one assembly."""
    stories = [_make_story(f"mesh{i}") for i in range(4)]
    jasm = SimpleNeuroidAssembly(stories, validation_method="outer")
    trim = {f"{s}_{k}_{e}": v for s in ("train", "test")
            for (k, e, v) in (("features", "start", 10),
                              ("features", "end", -5),
                              ("targets", "start", 10),
                              ("targets", "end", -5))}

    def run(pkg, model, asm, name):
        kw = dict(device="cpu") if pkg is T else {}
        trainer = pkg.AbstractTrainer(
            assembly=asm,
            feature_extractors=[pkg.FeatureExtractorFactory.create_extractor(
                "wordrate", "wordrate", {},
                cache_dir=str(tmp_path / name / "cache"))],
            downsampler=pkg.Downsampler(), model=model,
            fir_delays=[1, 2, 3, 4], trimming_config=dict(trim),
            use_train_test_split=True, dataset_type="lebel",
            logger_backend="none", results_dir=str(tmp_path / name), **kw)
        return trainer.train(chunk_length=10, n_inner_folds=3)

    want = run(J, J.NestedCVModel(seed=0, n_devices=8), jasm, "jax")
    tasm = assembly_from_reference(jasm)
    plain = run(T, T.NestedCVModel(seed=0, device="cpu"), tasm, "plain")
    got = run(T, T.NestedCVModel(seed=0, n_devices=8, device="cpu"), tasm,
              "mesh")
    _assert_sharded(got, want, plain, atol=1e-4, median_atol=1e-4)
    assert got["median_score"] > 0.25


def test_mesh_rejects_bad_arguments(monkeypatch):
    X, Y, Xt, Yt = _problem(5, T_=80, Tp=20, V=4)
    with pytest.raises(RuntimeError, match="devices") as want:
        jcv.fit_nested_cv(X, Y, X_test=Xt, y_test=Yt, n_devices=4096)
    with pytest.raises(ValueError, match="n_devices") as want_v:
        jcv.fit_nested_cv(X, Y, X_test=Xt, y_test=Yt, mesh=jmake_mesh(8),
                          n_devices=4)
    with pytest.raises(ValueError) as got_v:
        tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu", n_devices=4,
                          mesh=make_mesh(devices=["cpu"] * 8))
    assert str(got_v.value) == str(want_v.value)
    with pytest.raises(TypeError, match="Mesh"):
        tcv.fit_nested_cv(X, Y, Xt, Yt, device="cpu", mesh=object())
    # The card path: a one-card machine refuses a 4096-card mesh with the
    # JAX wording before any data moves.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError) as got:
        tcv.fit_nested_cv(X, Y, Xt, Yt, n_devices=4096)
    assert str(got.value).split(" but ")[0] == str(want.value).split(
        " but ")[0] == "make_mesh(4096) needs 4096 devices"


def test_cli_n_devices_flag():
    argv = ["--dataset_type", "lebel", "--modality", "wordrate",
            "--model_name", "wordrate", "--ndelays", "4", "--lookback", "256",
            "--cache_dir", "/tmp/c", "--n_devices", "8", "--device", "cpu"]
    args = tcli.parse_args(argv)
    assert args.n_devices == 8 == jcli.parse_args(argv[:-2]).n_devices
    assert args.device == "cpu"


# ---- banded -----------------------------------------------------------------

def _assert_banded(got, want, plain):
    (mt, wt, at, gt), (mj, wj, aj, gj), (mp, wp, ap, gp) = got, want, plain
    assert mt["solver_paths"] == mj["solver_paths"]
    assert mt["solver_paths"]["banded_refit"] == "spectral"
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(at, ap)
    np.testing.assert_array_equal(gt, gp)
    np.testing.assert_allclose(wt, wj, atol=1e-4 * np.abs(wj).max())
    np.testing.assert_allclose(wt, wp, atol=1e-5 * np.abs(wp).max())
    if "correlations" in mj:
        np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                                   atol=2e-4)
        np.testing.assert_allclose(mt["correlations"], mp["correlations"],
                                   atol=1e-5)
        assert mt["n_significant"] == mj["n_significant"]


def test_banded_fit_mesh_invariant(caplog):
    Xs, Y, Xts, Yt = _spaces(6)
    kw = dict(KW, n_gammas=3)
    want = jb.fit_banded_ridge(Xs, Y, X_tests=Xts, y_test=Yt, n_devices=8,
                               **kw)
    plain = tb.fit_banded_ridge(Xs, Y, Xts, Yt, device="cpu", **kw)
    with caplog.at_level(logging.INFO,
                         logger="litcoder_core_torch.models.banded"):
        got = tb.fit_banded_ridge(Xs, Y, Xts, Yt, n_devices=8, device="cpu",
                                  **kw)
    assert any("voxel-sharded scan: 21 voxels (+3 pad) over 8 devices"
               in r.message for r in caplog.records)
    assert plain[0]["solver_paths"]["banded_refit"] == "grouped_chol"
    _assert_banded(got, want, plain)


def test_banded_fit_mesh_invariant_svd_fallback():
    Xs, Y, _, _ = _spaces(7, T_=160, V=13, dims=(5, 3))
    kw = dict(alphas=np.logspace(-1, 3, 4), n_gammas=3, chunk_length=10,
              n_inner_folds=3, seed=0, method="svd")
    want = jb.fit_banded_ridge(Xs, Y, n_devices=8, **kw)
    plain = tb.fit_banded_ridge(Xs, Y, device="cpu", **kw)
    got = tb.BandedRidgeModel(n_devices=8, device="cpu").fit_predict(
        Xs, Y, **kw)
    assert got[0]["solver_paths"]["banded_scan"] == "svd_fallback"
    _assert_banded(got, want, plain)


def test_mesh_solve_side_follows_the_whole_voxel_axis(monkeypatch):
    """V=80 over 8 shards: each shard holds 10 voxels, fewer than the 60
    validation rows, but the JAX package's sharded program sees V=80 and
    solves against Xva^T (the factor side), as the unsharded fit does; the
    port's shards must too (banded chol scan and the dual search)."""
    calls = {"banded_voxel_side": 0, "dual_voxel_side": 0}
    real_zscore = tb.zscore
    real_dual = tcv._score_fold_dual_voxel_side

    def spy_zscore(*a, **k):
        # Unchunked, banded.py z-scores the val block only on its voxel
        # side; the factor side scores through nested_cv's helpers.
        calls["banded_voxel_side"] += 1
        return real_zscore(*a, **k)

    def spy_dual(*a, **k):
        calls["dual_voxel_side"] += 1
        return real_dual(*a, **k)

    monkeypatch.setattr(tb, "zscore", spy_zscore)
    monkeypatch.setattr(tcv, "_score_fold_dual_voxel_side", spy_dual)
    Xs, Y, _, _ = _spaces(10, V=80)
    kw = dict(KW, n_gammas=2)
    want = jb.fit_banded_ridge(Xs, Y, n_devices=8, **kw)
    got = tb.fit_banded_ridge(Xs, Y, n_devices=8, device="cpu", **kw)
    assert calls["banded_voxel_side"] == 0
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    X, Y, _, _ = _problem(11, T_=240, D=300, V=80)      # wide: dual search
    want, _, _ = jcv.fit_nested_cv(X, Y, n_devices=8, n_outer_folds=3, **KW)
    got, _, _ = tcv.fit_nested_cv(X, Y, n_devices=8, n_outer_folds=3,
                                  device="cpu", **KW)
    assert got["solver_paths"]["alpha_search"] == "dual"
    assert calls["dual_voxel_side"] == 0
    np.testing.assert_array_equal(got["best_alphas"], want["best_alphas"])


# ---- stacking ---------------------------------------------------------------

def _assert_stacked(got, want, plain):
    (mt, wt, at), (mj, wj, aj), (mp, wp, ap) = got, want, plain
    assert mt["solver_paths"] == mj["solver_paths"]
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_array_equal(at, ap)
    assert wt.shape == wj.shape and at.shape == aj.shape
    np.testing.assert_allclose(wt, wj, atol=1e-4)
    np.testing.assert_allclose(wt, wp, atol=1e-5)
    np.testing.assert_allclose(wt.sum(axis=1), 1.0, atol=1e-5)
    if "correlations" in mj:
        np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                                   atol=2e-4)
        np.testing.assert_allclose(mt["correlations"], mp["correlations"],
                                   atol=1e-5)
        for s in range(len(mt["per_space_test_r"])):
            np.testing.assert_allclose(mt["per_space_test_r"][s],
                                       mj["per_space_test_r"][s], atol=2e-4)


def test_stacked_fit_mesh_invariant(caplog):
    Xs, Y, Xts, Yt = _spaces(8)
    want = js.fit_stacked_ridge(Xs, Y, X_tests=Xts, y_test=Yt, n_devices=8,
                                **KW)
    plain = ts.fit_stacked_ridge(Xs, Y, Xts, Yt, device="cpu", **KW)
    with caplog.at_level(logging.INFO,
                         logger="litcoder_core_torch.models.stacking"):
        got = ts.fit_stacked_ridge(Xs, Y, Xts, Yt, n_devices=8, device="cpu",
                                   **KW)
    assert any("stacked voxel-sharded fit: 21 voxels (+3 pad) over 8"
               in r.message for r in caplog.records)
    assert got[0]["solver_paths"]["oof_refit"] == "pervoxel_chol"
    assert plain[0]["solver_paths"]["oof_refit"] == "grouped_chol"
    _assert_stacked(got, want, plain)


def test_stacked_fit_mesh_invariant_spectral_path():
    Xs, Y, _, _ = _spaces(9, T_=200, V=17, dims=(5, 3))
    kw = dict(alphas=np.logspace(-1, 3, 4), chunk_length=10,
              n_inner_folds=3, seed=0, singcutoff=1e-6)
    want = js.fit_stacked_ridge(Xs, Y, n_devices=8, **kw)
    plain = ts.fit_stacked_ridge(Xs, Y, device="cpu", **kw)
    got = ts.StackedRidgeModel(n_devices=8, device="cpu").fit_predict(
        Xs, Y, **kw)
    assert got[0]["solver_paths"]["oof_refit"] == "spectral"
    _assert_stacked(got, want, plain)


# ---- the command line -------------------------------------------------------

@pytest.fixture(scope="module")
def cli_pickle(tmp_path_factory):
    stories = [_make_story(f"cli_mesh{i}") for i in range(3)]
    path = str(tmp_path_factory.mktemp("mesh_cli") / "asm.pkl")
    save_assembly(SimpleNeuroidAssembly(stories, "outer"), path)
    return path


@pytest.mark.parametrize("mode", ["plain", "banded", "stacking"])
def test_cli_n_devices_end_to_end(mode, cli_pickle, tmp_path):
    """--n_devices 8 through run(): the port on 8 CPU entries against the
    JAX CLI on its 8-device mesh and the port's unsharded run."""
    over = {"plain": dict(banded=False),
            "banded": dict(),
            "stacking": dict(banded=False, stacking=True,
                             modalities=["wordrate", "wordrate"],
                             model_names=["wordrate", "wordrate"])}[mode]

    def config(name, **extra):
        cfg = _banded_config(tmp_path, cli_pickle,
                             cache_dir=str(tmp_path / name / "c"),
                             results_dir=str(tmp_path / name / "r"),
                             **over, **extra)
        if mode == "stacking":
            cfg.pop("n_gammas")
        return cfg

    want = jcli.run(config("jax", n_devices=8))
    plain = tcli.run(config("plain", device="cpu"))
    got = tcli.run(config("mesh", n_devices=8, device="cpu"))
    assert got["median_score"] > 0.2
    _assert_sharded(got, want, plain)
    if mode == "banded":
        np.testing.assert_array_equal(got["best_gammas"], want["best_gammas"])
        np.testing.assert_array_equal(got["best_gammas"],
                                      plain["best_gammas"])
    if mode == "stacking":
        np.testing.assert_allclose(got["stack_weights_mean"],
                                   want["stack_weights_mean"], atol=1e-4)
