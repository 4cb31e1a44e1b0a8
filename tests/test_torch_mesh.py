"""Port parity for the voxel mesh (parallel/mesh.py) and the voxel-sharded
fused step (make_nested_cv_step(mesh=...)): the port on a mesh of CPU
entries against the JAX package on its 8 virtual CPU devices, on the same
seeded numpy problems. Bars: the step's (tests/test_torch_step.py):
identical selected alphas, correlations and p-values within 2e-4, weights
within 1e-4 of their max."""

import numpy as np
import pytest
import torch

from litcoder_core_torch.parallel import mesh as tmesh
from litcoder_core_torch.parallel import step as tstep
from litcoder_core_tpu.parallel import mesh as jmesh
from litcoder_core_tpu.parallel import step as jstep

torch.set_num_threads(2)

D, V = 8, 32
GRID = np.logspace(-1, 3, 5).astype(np.float32)


def _cpu_mesh(n, axis=tmesh.VOX_AXIS):
    return tmesh.make_mesh(devices=["cpu"] * n, axis=axis)


def _problem(T=128, d=D, v=V, Tp=32, seed=1):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(d, v)).astype(np.float32) * rng.uniform(0.1, 1, v)
    X = rng.normal(size=(T + Tp, d)).astype(np.float32)
    Y = (X @ W.astype(np.float32)
         + rng.normal(size=(T + Tp, v))).astype(np.float32)
    return X[:T], Y[:T], X[T:], Y[T:]


# ---- meshes and placement ---------------------------------------------------

def test_make_mesh_shapes():
    m = _cpu_mesh(8)
    assert m.shape == dict(jmesh.make_mesh(8).shape) == {"vox": 8}
    assert m.size == 8 and m.axis_names == ("vox",)
    assert {str(d) for d in m.devices.flat} == {"cpu"}
    assert m.distinct_devices() == [torch.device("cpu")]
    assert _cpu_mesh(3, axis="x").shape == {"x": 3}


def test_make_mesh_refuses_more_cards_than_exist(monkeypatch):
    """make_mesh(n) never truncates: JAX's wording, counting cards."""
    with pytest.raises(RuntimeError) as want:
        jmesh.make_mesh(4096)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError) as got:
        tmesh.make_mesh(4096)
    prefix = "make_mesh(4096) needs 4096 devices but only"
    assert str(want.value).startswith(prefix)
    assert str(got.value).startswith(prefix + " 1 exist (platform=cuda)")


def test_resolve_voxel_mesh_matches_jax():
    assert tmesh.resolve_voxel_mesh(None, None, device="cpu") is None
    m = tmesh.resolve_voxel_mesh(None, 8, device="cpu")
    assert m.shape == {"vox": 8} and m.devices[0].type == "cpu"
    one = _cpu_mesh(8)
    assert tmesh.resolve_voxel_mesh(one, 8, device="cpu") is one
    two_d = tmesh.Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2),
                       ("a", "b"))
    from jax.sharding import Mesh as JMesh
    import jax
    j2 = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("a", "b"))
    for args_t, args_j in (((two_d, None), (j2, None)),
                           ((one, 4), (jmesh.make_mesh(8), 4))):
        with pytest.raises(ValueError) as want:
            jmesh.resolve_voxel_mesh(*args_j, who="fit")
        with pytest.raises(ValueError) as got:
            tmesh.resolve_voxel_mesh(*args_t, who="fit", device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="Mesh"):
        tmesh.resolve_voxel_mesh(object(), None, device="cpu")
    # A CUDA fit never runs on CPU entries (nor the reverse).
    with pytest.raises(ValueError, match="mesh's devices"):
        tmesh.resolve_voxel_mesh(one, None, device="cuda")


def test_shard_replicate_gather():
    m = _cpu_mesh(4)
    Y = np.arange(3 * 8, dtype=np.float32).reshape(3, 8)
    sh = tmesh.shard_voxels(Y, m)
    assert sh.shape == (3, 8)
    assert [tuple(s.shape) for s in sh.shards] == [(3, 2)] * 4
    for i, s in enumerate(sh.shards):
        np.testing.assert_array_equal(s.numpy(), Y[:, 2 * i:2 * i + 2])
    np.testing.assert_array_equal(sh.gather("cpu").numpy(), Y)
    t = torch.as_tensor(Y)
    sh_t = tmesh.shard_voxels(t, m)
    assert all(s.is_contiguous() for s in sh_t.shards)
    sh_t.shards[0][0, 0] = -1.0          # a shard is a copy, not a view
    assert t[0, 0] == 0.0
    rep = tmesh.replicate(np.ones((5, 2), np.float32), m)
    assert list(rep) == [torch.device("cpu")]  # one copy per distinct device
    assert [k for k, _ in m.transfers] == (["shard"] * 4 + ["gather"] * 4
                                           + ["shard"] * 4 + ["replicate"])
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_voxels(np.zeros((2, 7), np.float32), m)


def test_pad_voxels_matches_jax():
    Y = np.ones((10, 13), np.float32)
    got, v0 = tmesh.pad_voxels(Y, 8)
    want, w0 = jstep.pad_voxels(Y, 8)
    assert v0 == w0 == 13 and tuple(got.shape) == want.shape == (10, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tstep.pad_voxels is tmesh.pad_voxels


# ---- the voxel-sharded step -------------------------------------------------

STEP_CASES = {
    "auto": dict(), "chol": dict(method="chol"), "eigh": dict(method="eigh"),
    "svd": dict(method="svd"), "single_alpha": dict(single_alpha=True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_sharded_step_matches_jax_mesh_step(case):
    kw = STEP_CASES[case]
    X, Y, Xt, Yt = _problem()
    tr, va = jstep.equal_size_folds(X.shape[0], 4, 8, seed=0)
    want = jstep.make_nested_cv_step(mesh=jmesh.make_mesh(8), **kw)(
        X, Y, Xt, Yt, GRID, tr, va)
    got = tstep.make_nested_cv_step(mesh=_cpu_mesh(8), device="cpu", **kw)(
        X, Y, Xt, Yt, GRID, tr, va)
    assert isinstance(got.correlations, tmesh.VoxelShards)
    rt, pt, at, wt = (f.gather("cpu").numpy() for f in got)
    np.testing.assert_array_equal(at, np.asarray(want.best_alphas))
    np.testing.assert_allclose(rt, np.asarray(want.correlations), atol=2e-4)
    np.testing.assert_allclose(pt, np.asarray(want.pvalues), atol=2e-4)
    wj = np.asarray(want.weights)
    np.testing.assert_allclose(wt, wj, atol=1e-4 * np.abs(wj).max())
    plain = tstep.nested_cv_step(X, Y, Xt, Yt, GRID, tr, va, device="cpu",
                                 **kw)
    np.testing.assert_array_equal(at, plain.best_alphas.numpy())
    np.testing.assert_allclose(rt, plain.correlations.numpy(), atol=1e-5)


def test_sharded_step_refuses_an_undivided_voxel_axis():
    X, Y, Xt, Yt = _problem(v=V + 1)
    tr, va = jstep.equal_size_folds(X.shape[0], 2, 8, seed=0)
    with pytest.raises(ValueError, match="not divisible"):
        tstep.make_nested_cv_step(mesh=_cpu_mesh(8), device="cpu")(
            X, Y, Xt, Yt, GRID, tr, va)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_per_device_shards_scale_inverse_with_mesh(n):
    """Every shard of the inputs AND outputs holds 1/n of the voxel axis
    (the counterpart of test_parallel.py's test of the same name)."""
    v = 16 * n
    X, Y, Xt, Yt = _problem(v=v)
    tr, va = jstep.equal_size_folds(X.shape[0], 4, 8)
    m = _cpu_mesh(n)
    Ysh = tmesh.shard_voxels(Y, m)
    assert {tuple(s.shape) for s in Ysh.shards} == {(Y.shape[0], v // n)}
    out = tstep.make_nested_cv_step(mesh=m, device="cpu")(
        X, Ysh, Xt, Yt, GRID, tr, va)
    assert len(out.weights.shards) == n
    assert {tuple(s.shape) for s in out.correlations.shards} == {(v // n,)}
    assert {tuple(s.shape) for s in out.best_alphas.shards} == {(v // n,)}
    assert {tuple(s.shape) for s in out.weights.shards} == {(D, v // n)}


@pytest.mark.parametrize("method,scan", [
    ("eigh", "eigh"), ("svd", "eigh"), ("woodbury", "woodbury"),
    ("chol", "chol"),
])
def test_sharded_step_moves_only_x_side_and_final_gather(method, scan,
                                                        caplog):
    """The counterpart of test_compiled_sharded_step_has_no_tensor_
    collectives: during the sharded step the mesh helpers place Y and
    Y_test shard by shard and replicate X and X_test, and nothing else
    crosses shards; the only later movement is the caller's gather of the
    outputs. Each device also builds the X side once: with 8 shards on one
    device the per-fold factors are made once per fold, not per shard."""
    X, Y, Xt, Yt = _problem(v=64)
    tr, va = jstep.equal_size_folds(X.shape[0], 4, 8)
    m = _cpu_mesh(8)
    counts = {"chol": 0, "states": 0}
    real_chol = tstep._complement_fold_factors
    real_states = tstep._fold_states_complement

    def chol(*a, **k):
        counts["chol"] += 1
        return real_chol(*a, **k)

    def states(*a, **k):
        counts["states"] += 1
        return real_states(*a, **k)

    with pytest.MonkeyPatch.context() as mp, caplog.at_level(
            "INFO", logger="litcoder_core_torch.parallel.step"):
        mp.setattr(tstep, "_complement_fold_factors", chol)
        mp.setattr(tstep, "_fold_states_complement", states)
        out = tstep.make_nested_cv_step(mesh=m, method=method,
                                        device="cpu")(
            X, Y, Xt, Yt, GRID, tr, va)
    route = "per_fold" if method == "svd" else scan
    assert any(f"{route} scan" in r.message for r in caplog.records)
    during = list(m.transfers)
    assert sorted(set(during)) == sorted({
        ("shard", (X.shape[0], 8)), ("shard", (Xt.shape[0], 8)),
        ("replicate", X.shape), ("replicate", Xt.shape)})
    assert [k for k, _ in during].count("shard") == 16
    assert [k for k, _ in during].count("replicate") == 2
    assert counts["chol"] == (4 if scan == "chol" else 0)
    assert counts["states"] == (1 if scan == "eigh" and method != "svd"
                                else 0)
    for field in out:
        field.gather("cpu")
    after = m.transfers[len(during):]
    assert {k for k, _ in after} == {"gather"} and len(after) == 4 * 8


@pytest.mark.parametrize("fit", ["banded", "stacked"])
def test_sharded_fits_move_only_shards_and_replicas(fit):
    """The counterpart of test_parallel.py's banded and stacking no-
    collective tests: a voxel-sharded banded or stacked fit places the
    responses shard by shard and the stimuli once per device, and its
    helpers move nothing else between shards (the scores meet for the
    argmax outside them, as JAX's sharded argmax fetches to the host)."""
    from litcoder_core_torch.models import fit_banded_ridge, fit_stacked_ridge

    rng = np.random.default_rng(5)
    Xs = [rng.normal(size=(120, d)).astype(np.float32) for d in (6, 4)]
    Xts = [rng.normal(size=(30, d)).astype(np.float32) for d in (6, 4)]
    Y = rng.normal(size=(120, 16)).astype(np.float32)
    Yt = rng.normal(size=(30, 16)).astype(np.float32)
    m = _cpu_mesh(8)
    kw = dict(alphas=GRID, chunk_length=10, n_inner_folds=3, seed=0,
              mesh=m, device="cpu")
    if fit == "banded":
        out = fit_banded_ridge(Xs, Y, Xts, Yt, n_gammas=2, **kw)
        want = {("shard", (120, 2)), ("replicate", (120, 10))}
    else:
        out = fit_stacked_ridge(Xs, Y, Xts, Yt, **kw)
        want = {("shard", (120, 2)), ("shard", (30, 2)),
                ("replicate", (120, 6)), ("replicate", (120, 4)),
                ("replicate", (30, 6)), ("replicate", (30, 4))}
    assert set(m.transfers) == want
    assert np.asarray(out[0]["correlations"]).shape == (16,)


def test_weak_scaling_shard_invariance():
    """Per-voxel results do not depend on the mesh hosting them: the
    8-shard step on 8 tiled copies of a problem gives the one-device
    step's results 8 times (test_parallel.py's case of the same name)."""
    X, Y, Xt, Yt = _problem(v=16)
    tr, va = jstep.equal_size_folds(X.shape[0], 4, 8)
    base = tstep.nested_cv_step(X, Y, Xt, Yt, GRID, tr, va, device="cpu")
    out = tstep.make_nested_cv_step(mesh=_cpu_mesh(8), device="cpu")(
        X, np.tile(Y, (1, 8)), Xt, np.tile(Yt, (1, 8)), GRID, tr, va)
    np.testing.assert_allclose(out.correlations.gather("cpu").numpy(),
                               np.tile(base.correlations.numpy(), 8),
                               atol=1e-5)
    np.testing.assert_array_equal(out.best_alphas.gather("cpu").numpy(),
                                  np.tile(base.best_alphas.numpy(), 8))
