"""Port parity for full nested-CV mode, the dual (kernel-ridge) search, the
normalizers and the Fisher combination: the port on the CPU against the JAX
package on the same seeded numpy problems. Bars (README's solver parity):
identical selected alphas, correlations within 2e-3, median r within 1e-3,
identical metric keys, solver_paths, n_significant and
n_majority_significant, weights within 1e-3 of their max."""

import numpy as np
import pytest
import torch

import litcoder_core_tpu as J
import litcoder_core_torch as T
from litcoder_core_torch.assembly.convert import assembly_from_reference
from litcoder_core_torch.models import nested_cv as tcv
from litcoder_core_torch.models import normalizer as tnorm
from litcoder_core_torch.ops import stats as tstats
from litcoder_core_tpu.models import nested_cv as jcv
from litcoder_core_tpu.models import normalizer as jnorm
from litcoder_core_tpu.ops import stats as jstats
from tests.test_trainer_e2e import _make_story

torch.set_num_threads(2)

FUSED = {"mode": "full_cv_fused", "alpha_search": "fused_chol",
         "fast_scan": "off"}
PER_FOLD_DUAL = {"mode": "full_cv_per_fold", "alpha_search": "dual",
                 "fast_scan": "off"}
PER_FOLD_CHOL = {"mode": "full_cv_per_fold", "alpha_search": "chol",
                 "fast_scan": "off"}


def _problem(T, D, V, seed=0, scale=1.0):
    """X (T, D), Y = X W + noise with voxel gains spread over a decade."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T, D)).astype(np.float32)
    W = (rng.normal(size=(D, V)) * rng.uniform(0.02, 0.3, V)
         * scale / np.sqrt(max(D / 10, 1.0))).astype(np.float32)
    Y = (X @ W + rng.normal(size=(T, V))).astype(np.float32)
    return X, Y


def _assert_parity(got, want, paths):
    mt, wt, at = got
    mj, wj, aj = want
    np.testing.assert_array_equal(at, aj)
    assert set(mt) == set(mj)
    assert mt["solver_paths"] == mj["solver_paths"] == paths
    np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                               atol=2e-3)
    assert abs(mt["median_score"] - mj["median_score"]) <= 1e-3
    assert mt["n_significant"] == mj["n_significant"]
    if "n_majority_significant" in mj:
        assert (mt["n_majority_significant"]
                == mj["n_majority_significant"])
    if wj is None:
        assert wt is None
    else:
        np.testing.assert_allclose(wt, wj, atol=1e-3 * np.abs(wj).max())


def _both(X, Y, *args, **kw):
    return (tcv.fit_nested_cv(X, Y, *args, device="cpu", **kw),
            jcv.fit_nested_cv(X, Y, *args, **kw))


# --- full-CV mode, both routes ----------------------------------------------


@pytest.mark.parametrize("return_weights", [True, False])
def test_fused_route_matches_jax(return_weights):
    """810 rows in chunks of 20 leave a 10-row remainder outside every fold
    (the union's leftover downdate); inner folds leave their own."""
    X, Y = _problem(810, 30, 20)
    got, want = _both(X, Y, chunk_length=20, n_outer_folds=4,
                      n_inner_folds=3, seed=2, return_weights=return_weights)
    _assert_parity(got, want, FUSED)
    assert got[0]["n_majority_significant"] > 0


def test_fused_route_without_correlation_scores_matches_jax():
    X, Y = _problem(600, 24, 16, seed=3, scale=2.0)
    _assert_parity(*_both(X, Y, chunk_length=20, n_outer_folds=3,
                          n_inner_folds=3, use_corr=False), FUSED)


@pytest.mark.parametrize("V", [20, 80], ids=["voxel_side", "whole"])
def test_per_fold_dual_route_matches_jax(V):
    """Wide kfold_trimmed folds (about 130 inner train rows for 200
    features) take the dual search; V=20 is under the inner val width, so
    its folds score through the voxel-side dual."""
    X, Y = _problem(300, 200, V)
    _assert_parity(*_both(X, Y, folding_type="kfold_trimmed",
                          chunk_length=20, n_outer_folds=3, n_inner_folds=3),
                   PER_FOLD_DUAL)


def test_per_fold_dual_route_single_alpha_matches_jax():
    X, Y = _problem(300, 200, 40, seed=5)
    got, want = _both(X, Y, folding_type="kfold_trimmed", chunk_length=20,
                      n_outer_folds=3, n_inner_folds=4, single_alpha=True,
                      use_corr=False)
    _assert_parity(got, want, PER_FOLD_DUAL)


@pytest.mark.parametrize("folding_type", ["kfold_trimmed", "chunked"])
def test_per_fold_normalized_route_matches_jax(folding_type):
    """Normalization changes the data between outer folds, so even chunked
    folds take the per-fold route."""
    X, Y = _problem(300, 20, 20, seed=1)
    X = X * np.linspace(0.5, 3.0, 20, dtype=np.float32) + 1.5
    _assert_parity(*_both(X, Y, folding_type=folding_type, chunk_length=20,
                          n_outer_folds=3, n_inner_folds=3,
                          normalize_features=True, normalize_targets=True),
                   PER_FOLD_CHOL)


@pytest.mark.parametrize("shared", [True, False],
                         ids=["one_list", "per_fold_lists"])
def test_injected_splits_match_jax(shared):
    X, Y = _problem(400, 24, 12, seed=6)
    outer = tcv.create_folds(400, "chunked", 4, 20, seed=1)
    if shared:
        inner = tcv.create_folds(300, "kfold", 3)
    else:
        inner = [tcv.create_folds(len(tr), "chunked", 3, 10, seed=k)
                 for k, (tr, _) in enumerate(outer)]
    _assert_parity(*_both(X, Y, outer_splits=outer, inner_splits=inner),
                   FUSED)


def test_group_folds_match_jax():
    """Group outer folds, with inner group folds over each fold's own
    groups; uneven groups are not partition-union, so per-fold."""
    X, Y = _problem(360, 20, 12, seed=7)
    groups = np.repeat(np.arange(12), 30)
    groups[:45] = 99
    got, want = _both(X, Y, folding_type="group", groups=groups,
                      n_outer_folds=4, n_inner_folds=3)
    assert got[0]["solver_paths"]["mode"] == want[0]["solver_paths"]["mode"]
    _assert_parity(got, want, want[0]["solver_paths"])


def test_model_api_in_full_cv_mode_matches_jax():
    X, Y = _problem(400, 16, 10, seed=8)
    kw = dict(chunk_length=20, n_outer_folds=3, n_inner_folds=3)
    got = tcv.NestedCVModel(seed=4, device="cpu").fit_predict(X, Y, **kw)
    want = jcv.NestedCVModel(seed=4).fit_predict(X, Y, **kw)
    _assert_parity(got, want, FUSED)


def test_full_cv_gates_match_jax():
    tall = [tcv.create_folds(300, "chunked", 3, 20, seed=s)
            for s in range(3)]
    outer = tcv.create_folds(400, "chunked", 4, 20, seed=0)
    trimmed = tcv.create_folds(400, "kfold_trimmed", 4)
    cases = [
        ("auto", True, 1e-10, False, outer, tall, 24),
        ("auto", True, 1e-10, False, outer, tall, 500),
        ("auto", True, 1e-10, False, trimmed, tall, 24),
        ("chol", True, 1e-10, False, outer, tall, 24),
        ("eigh", True, 1e-10, False, outer, tall, 24),
        ("auto", False, 1e-10, False, outer, tall, 24),
        ("auto", True, 1e-3, False, outer, tall, 24),
        ("auto", True, 1e-10, True, outer, tall, 24),
    ]
    seen = set()
    for method, normalpha, cut, norm, out, inner, d in cases:
        args = (method, normalpha, np.logspace(-1, 8, 10), cut, norm, False,
                out, inner, d)
        want = jcv._full_cv_fused_eligible(*args)
        assert tcv._full_cv_fused_eligible(*args) == want
        seen.add(want)
    assert seen == {True, False}
    for folds in (outer, trimmed, tall[0]):
        folds = [(np.asarray(a), np.asarray(b)) for a, b in folds]
        assert (tcv._folds_partition_union(folds)
                == jcv._folds_partition_union(folds))


# --- the pieces of each route -----------------------------------------------


def test_fused_inner_fold_and_refit_match_jax():
    X, Y = _problem(400, 24, 16, seed=9)
    tr, te = tcv.create_folds(400, "chunked", 4, 20, seed=0)[1]
    va = tr[40:100]
    lo = tr[-7:]
    alphas = np.logspace(-1, 4, 6).astype(np.float32)
    tX, tY = torch.as_tensor(X), torch.as_tensor(Y)
    G_j, XtY_j = jcv._downdate_outer(X, Y, jcv._full_gram(X),
                                     jcv._xty(X, Y), te)
    G_t, XtY_t = tcv._downdate_outer(tX, tY, tX.T @ tX, tX.T @ tY,
                                     torch.as_tensor(te))
    np.testing.assert_allclose(G_t.numpy(), np.asarray(G_j), rtol=1e-4,
                               atol=1e-3)
    sj = jcv._score_inner_fold_from_gram(X, Y, va, lo, G_j, XtY_j, alphas,
                                         True, True)
    st = tcv._score_inner_fold_from_gram(tX, tY, torch.as_tensor(va),
                                         torch.as_tensor(lo), G_t, XtY_t,
                                         torch.as_tensor(alphas), True, True)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-4)
    valphas = np.full(16, 10.0, np.float32)
    wj, cj, _ = jcv._refit_score_from_gram(G_j, XtY_j, X[te], Y[te],
                                           valphas, 1e-10, True, True)
    wt, ct, _ = tcv._refit_score_from_gram(G_t, XtY_t, tX[te], tY,
                                           torch.as_tensor(te),
                                           torch.as_tensor(valphas), 1e-10,
                                           True, True)
    wj = np.asarray(wj)
    np.testing.assert_allclose(wt, wj, atol=1e-4 * np.abs(wj).max())
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-4)


@pytest.mark.parametrize("normalpha", [True, False])
def test_dual_fold_factors_and_scores_match_jax(normalpha):
    """One wide fold: the dual factors M_a = (K_tr + a^2 I)^-1 K_tr,va are
    invariant (no eigenvector signs), and both scorers give the JAX (A, V)
    fold scores."""
    X, Y = _problem(120, 300, 50, seed=10)
    tr, va = tcv.create_folds(120, "kfold", 4)[1]
    alphas = np.logspace(-1, 4, 6).astype(np.float32)
    tX, tY, ta = (torch.as_tensor(a) for a in (X, Y, alphas))
    ttr, tva = torch.as_tensor(tr), torch.as_tensor(va)
    Kj = jcv._full_kernel(X)
    Kt = tcv._full_kernel(tX)
    Mj = np.asarray(jcv._dual_fold_factors(Kj, tr, va, alphas, normalpha))
    Mt = tcv._dual_fold_factors(Kt, ttr, tva, ta, normalpha).numpy()
    np.testing.assert_allclose(Mt, Mj, atol=1e-4 * np.abs(Mj).max())
    sj = np.asarray(jcv._score_fold_dual_whole(Y, tr, va, Mj, True))
    st = tcv._score_fold_voxel_chunks(torch.as_tensor(Mt), tY, True, None,
                                      form="dual", tr=ttr, va=tva)
    np.testing.assert_allclose(st.numpy(), sj, atol=2e-4)
    vj = np.asarray(jcv._score_fold_dual_voxel_side(Kj, Y[:, :20], tr, va,
                                                    alphas, normalpha, True))
    vt = tcv._score_fold_dual_voxel_side(Kt, tY[:, :20], ttr, tva, ta,
                                         normalpha, True)
    np.testing.assert_allclose(vt.numpy(), vj, atol=2e-4)
    np.testing.assert_allclose(vt.numpy(), st.numpy()[:, :20], atol=2e-4)


def test_dual_gate_matches_jax():
    wide = tcv.create_folds(100, "kfold", 4)
    for method, normalpha, alphas, cut, d in [
            ("auto", True, [0.1, 1.0], 1e-10, 200),
            ("auto", True, [0.1, 1.0], 1e-10, 50),
            ("auto", True, [0.01, 1.0], 1e-10, 200),
            ("auto", False, [0.1, 1.0], 1e-10, 200),
            ("auto", True, [0.1, 1.0], 1e-3, 200),
            ("dual", False, [0.0], 1.0, 10),
            ("eigh", True, [0.1, 1.0], 1e-10, 200)]:
        args = (method, normalpha, alphas, wide, d, cut)
        assert (tcv._dual_search_eligible(*args)
                == jcv._dual_search_eligible(*args))


def test_train_test_wide_fit_takes_the_dual_search():
    X, Y = _problem(300, 250, 30, seed=11)
    Xt, Yt = _problem(80, 250, 30, seed=12)
    got, want = _both(X, Y, Xt, Yt, chunk_length=20, n_inner_folds=4)
    _assert_parity(got, want, {"mode": "train_test", "alpha_search": "dual",
                               "fast_scan": "off"})


def test_train_test_explicit_dual_and_normalizers_match_jax():
    """Wide folds: on tall ones the kernel is rank-deficient, where both
    packages' Lanczos lambda-max can miss the f32 breakdown (ROADMAP C)."""
    X, Y = _problem(240, 260, 20, seed=13)
    Xt, Yt = _problem(100, 260, 20, seed=14)
    X = X * 3.0 + 2.0
    got, want = _both(X, Y, Xt, Yt, chunk_length=20, n_inner_folds=5,
                      method="dual", normalize_features=True,
                      normalize_targets=True)
    _assert_parity(got, want, {"mode": "train_test", "alpha_search": "dual",
                               "fast_scan": "off"})


# --- host statistics and the normalizer -------------------------------------


def test_fisher_combination_matches_jax_and_scipy():
    from scipy.stats import combine_pvalues

    rng = np.random.default_rng(15)
    p = rng.uniform(1e-6, 1.0, size=(5, 40))
    p[:, 0] = 1.0                     # all 1: the reference's guard keeps 1
    p[2, 1] = 0.0                     # log 0: infinite statistic, p 0
    p[:, 2] = [1.0, 1.0, 0.5, 1.0, 1.0]
    got = tstats.fisher_combine_pvalues_f64(p)
    np.testing.assert_array_equal(got, jstats.fisher_combine_pvalues_f64(p))
    assert got[0] == 1.0 and got[1] == 0.0
    for v in range(2, 40):
        np.testing.assert_allclose(
            got[v], combine_pvalues(p[:, v], method="fisher")[1],
            rtol=1e-12)


@pytest.mark.parametrize("features,targets", [(True, True), (True, False),
                                              (False, True)])
def test_normalizer_matches_jax(features, targets):
    rng = np.random.default_rng(16)
    X = (rng.normal(size=(50, 6)) * 4 + 3).astype(np.float32)
    Y = (rng.normal(size=(50, 5)) * 0.5 - 1).astype(np.float32)
    Xt = rng.normal(size=(20, 6)).astype(np.float32)
    Yt = rng.normal(size=(20, 5)).astype(np.float32)
    X[:, 2] = 7.0                     # zero std: eps keeps it finite
    port = tnorm.DataNormalizer(features, targets)
    ref = jnorm.DataNormalizer(features, targets)
    got = port.fit_transform(torch.as_tensor(X), torch.as_tensor(Y))
    got += port.transform(torch.as_tensor(Xt), torch.as_tensor(Yt))
    want = ref.fit_transform(X, Y) + ref.transform(Xt, Yt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="fit"):
        tnorm.DataNormalizer().transform(torch.as_tensor(X),
                                         torch.as_tensor(Y))


# --- the trainer in concatenated (full-CV) mode -----------------------------


NARRATIVES_TRIM = {"features_start": 14, "features_end": -9,
                   "targets_start": 14, "targets_end": -9}


@pytest.fixture(scope="module")
def concat_assembly():
    return J.SimpleNeuroidAssembly(
        [_make_story(f"narr{i}", n_trs=110) for i in range(3)],
        validation_method="inner")


def _concat_trainer(pkg, assembly, kv_path, results_dir):
    cfg = {"vector_path": kv_path, "lowercase": False}
    kwargs = dict(
        assembly=assembly,
        feature_extractors=[
            pkg.FeatureExtractorFactory.create_extractor("wordrate",
                                                         "wordrate", {}),
            pkg.FeatureExtractorFactory.create_extractor("embeddings",
                                                         "vecs", cfg),
        ],
        downsampler=pkg.Downsampler(),
        model=(pkg.NestedCVModel(seed=0, device="cpu") if pkg is T
               else pkg.NestedCVModel(seed=0)),
        fir_delays=list(range(1, 9)), trimming_config=dict(NARRATIVES_TRIM),
        use_train_test_split=False, dataset_type="narratives",
        logger_backend="none", results_dir=str(results_dir),
        downsample_config={"method": "lanczos", "window": 3,
                           "cutoff_mult": 1.0},
    )
    if pkg is T:
        kwargs["device"] = "cpu"
    return pkg.AbstractTrainer(**kwargs)


@pytest.mark.parametrize("dim,fit,paths", [
    (40, dict(folding_type="kfold_trimmed", chunk_length=20,
              single_alpha=True), PER_FOLD_DUAL),
    (3, dict(folding_type="chunked", chunk_length=10), FUSED),
], ids=["wide_kfold_trimmed", "tall_chunked"])
def test_concatenated_trainer_matches_jax(concat_assembly, tmp_path, dim,
                                          fit, paths):
    """Three stories of 110 TRs concatenated and trimmed 14:-9 (the
    narratives preset): (1 + 40) x 8 delays = 328 features against about
    190 inner train rows is wide (dual); (1 + 3) x 8 = 32 is tall and its
    chunked folds fuse."""
    from litcoder_core_tpu.features.embeddings import (
        SimpleKeyedVectors as JaxKV,
    )

    n = max(len(sd.words) for sd in concat_assembly.story_data.values())
    vecs = np.random.default_rng(17).normal(size=(n, dim)).astype(np.float32)
    kv_path = str(tmp_path / "vecs.kv")
    JaxKV([f"w{i}" for i in range(n)], vecs).save_kv(kv_path)
    kw = dict(fit, n_outer_folds=5, n_inner_folds=5)
    jt = _concat_trainer(J, concat_assembly, kv_path, tmp_path / "jax")
    tt = _concat_trainer(T, assembly_from_reference(concat_assembly), kv_path,
                         tmp_path / "torch")
    mj, mt = jt.train(**kw), tt.train(**kw)
    assert mt["solver_paths"] == mj["solver_paths"] == paths
    assert mt["best_alphas"] == mj["best_alphas"]
    np.testing.assert_allclose(mt["correlations"], mj["correlations"],
                               atol=2e-3)
    assert abs(mt["median_score"] - mj["median_score"]) <= 1e-3
    assert set(mt) == set(mj)
    assert mt["n_majority_significant"] == mj["n_majority_significant"]
    assert mt["median_score"] > 0.2   # the word-rate signal is recovered
    (run_dir,) = list(tt.model_saver.base_dir.glob("run_*"))
    _, alphas, hyper, metrics = tt.model_saver.load_encoding_model(run_dir)
    assert hyper["use_train_test_split"] is False
    np.testing.assert_array_equal(alphas, mt["best_alphas"])
    assert metrics["majority_significant_mask"] == \
        mt["majority_significant_mask"]


def test_concatenated_trainer_full_cv_weights(concat_assembly, tmp_path):
    """The trainer hands the mean full-CV weights to its saver."""
    from litcoder_core_torch.features.embeddings import SimpleKeyedVectors

    kv_path = str(tmp_path / "v.kv")
    n = max(len(sd.words) for sd in concat_assembly.story_data.values())
    SimpleKeyedVectors(
        [f"w{i}" for i in range(n)],
        np.random.default_rng(18).normal(size=(n, 2)).astype(np.float32),
    ).save_kv(kv_path)
    tt = _concat_trainer(T, assembly_from_reference(concat_assembly),
                         kv_path, tmp_path / "t")
    seen = {}
    tt.save_model = lambda w, a, m, kw: seen.update(w=w, a=a)
    metrics = tt.train(chunk_length=10, n_outer_folds=3, n_inner_folds=3)
    n_vox = len(metrics["correlations"])
    assert metrics["solver_paths"] == FUSED
    assert seen["w"].shape == (3 * 8, n_vox) and np.isfinite(seen["w"]).all()
    assert seen["a"].shape == (n_vox,)
