"""The refit's weights on their way to the host (utils.device.copy_to_host).

Each voxel chunk's weights go into their columns of one host array: on the
CPU by one copy, on CUDA in row blocks through a pinned staging ring of two
slots. Either way the array must hold, bit for bit, what the old fetch
gave (`.cpu().numpy()` of each chunk, then np.concatenate), and a fit that
returns no weights must not copy any. On the CPU the copies of the chunked
tests run as they would on the card; the tests marked `card` run the ring
itself and skip here. This file imports no JAX, so the card's machine runs
it:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_host_copy.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import profile

from litcoder_core_torch.models import nested_cv as tcv
from litcoder_core_torch.models.ridge import ridge_fit_from_svd, ridge_svd
from litcoder_core_torch.utils import device as tdev
from litcoder_core_torch.utils import profiling
from litcoder_core_torch.utils.device import copy_to_host, to_numpy

torch.set_num_threads(2)

DEVICE = torch.device("cuda" if torch.cuda.is_available() else "cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _old_fetch(chunks):
    """The fetch this replaces: each chunk to the host, then one concat."""
    return np.concatenate([to_numpy(c) for c in chunks], axis=1)


def _columns(V, chunk):
    return tcv._voxel_chunks(V, chunk)


# --- the helper ----------------------------------------------------------


@pytest.mark.parametrize("rows, cols, per_slot, n_blocks", [
    (6, 4, 24, 1),      # the whole array in one slot
    (7, 4, 12, 3),      # 3 rows a block: the last block holds one row
    (5, 4, 4, 5),       # a row a block
    (3, 10, 4, 9),      # a row outgrows a slot: pieces of 4, 4, 2
    (1, 1, 1, 1),
], ids=["one_block", "rows_with_tail", "row_a_block", "row_pieces", "one"])
def test_row_blocks_tile_the_array(rows, cols, per_slot, n_blocks):
    """Every element lies in exactly one block; each block holds at most a
    slot, and is contiguous in the C-ordered source (whole rows, or one
    row's piece)."""
    blocks = tdev._row_blocks(rows, cols, per_slot)
    assert len(blocks) == n_blocks
    hits = np.zeros((rows, cols), np.int64)
    for rs, cs in blocks:
        hits[rs, cs] += 1
        n_rows, n_cols = rs.stop - rs.start, cs.stop - cs.start
        assert n_rows * n_cols <= per_slot
        assert n_cols == cols or n_rows == 1
    np.testing.assert_array_equal(hits, 1)


@pytest.mark.parametrize("D, V, chunk, slot_floats", [
    (5, 12, None, 64),   # one chunk, one block
    (5, 11, 3, 64),      # several chunks with a tail
    (7, 8, None, 24),    # D that the row block (3 rows) does not divide
    (5, 2, 8, 64),       # V smaller than a chunk
    (3, 10, 4, 2),       # rows that outgrow a slot
], ids=["one_chunk", "chunks_with_tail", "rows_with_tail", "V_under_chunk",
        "row_pieces"])
def test_chunk_copies_equal_the_old_fetch(monkeypatch, D, V, chunk,
                                          slot_floats):
    """Chunks written into one preallocated array equal the old fetch bit
    for bit (on the card through a ring of `slot_floats`-float slots)."""
    monkeypatch.setattr(tdev, "STAGING_SLOT_BYTES", 4 * slot_floats)
    monkeypatch.setattr(tdev, "_staging_rings", {})
    g = torch.Generator().manual_seed(D * 100 + V)
    W = torch.randn(D, V, generator=g).to(DEVICE)
    chunks = [W[:, lo:hi].clone() for lo, hi in _columns(V, chunk)]
    out = np.empty((D, V), np.float32)
    for (lo, hi), c in zip(_columns(V, chunk), chunks):
        copy_to_host(out[:, lo:hi], c)
    want = _old_fetch(chunks)
    np.testing.assert_array_equal(out, want)
    assert out.flags.c_contiguous and out.dtype == np.float32


def test_copy_refuses_a_mismatched_destination():
    src = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="cannot copy"):
        copy_to_host(np.empty((4, 3), np.float32), src)
    with pytest.raises(ValueError, match="cannot copy"):
        copy_to_host(np.empty((3, 4), np.float64), src)


# --- the refit loops --------------------------------------------------------


def _problem(seed=0, T=120, D=6, V=10, Tte=30):
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.normal(size=(T, D)).astype(np.float32))
    Y = torch.as_tensor(rng.normal(size=(T, V)).astype(np.float32))
    Xte = torch.as_tensor(rng.normal(size=(Tte, D)).astype(np.float32))
    Yte = torch.as_tensor(rng.normal(size=(Tte, V)).astype(np.float32))
    alphas = np.logspace(0, 2, V).astype(np.float32)
    return X, Y, Xte, Yte, alphas


def _fit_and_score_weights(chunk):
    X, Y, Xte, Yte, alphas = _problem()
    got = tcv._fit_and_score(X, Y, Xte, Yte, alphas, True, 1e-10, chunk)
    svd = ridge_svd(X, None, singcutoff=1e-10, method="auto")
    nal = torch.as_tensor(alphas) * svd.S[0]
    want = _old_fetch([ridge_fit_from_svd(svd, Y[:, lo:hi], nal[lo:hi])
                       for lo, hi in _columns(Y.shape[1], chunk)])
    return got[0], want


def _refit_from_gram_weights(chunk):
    X, Y, _, _, alphas = _problem()
    te = torch.arange(90, 120)
    tr = torch.arange(0, 90)
    G_tr, XtY_tr = X[tr].T @ X[tr], X[tr].T @ Y[tr]
    nal = torch.as_tensor(alphas)
    got = tcv._refit_score_from_gram(G_tr, XtY_tr, X[te], Y, te, nal,
                                     1e-10, True, True, None, chunk)
    state = tcv._refit_state_from_gram(G_tr, 1e-10)
    nal = nal * state[0][0]
    want = _old_fetch([tcv._weights_from_state(state, XtY_tr[:, lo:hi],
                                               nal[lo:hi])
                       for lo, hi in _columns(Y.shape[1], chunk)])
    return got[0], want


@pytest.mark.parametrize("chunk", [None, 3])
@pytest.mark.parametrize("loop", [_fit_and_score_weights,
                                  _refit_from_gram_weights],
                         ids=["fit_and_score", "refit_from_gram"])
def test_refit_loops_return_the_old_weights(loop, chunk):
    got, want = loop(chunk)
    np.testing.assert_array_equal(got, want)
    assert got.flags.c_contiguous and got.dtype == np.float32


def _fit(mode, return_weights):
    X, Y, Xte, Yte, _ = _problem(1, T=200, V=9)
    kw = dict(device="cpu", seed=0, voxel_chunk_size=4,
              return_weights=return_weights)
    if mode == "train_test":
        return tcv.fit_nested_cv(X, Y, Xte, Yte, **kw)
    method = "auto" if mode == "full_cv_fused" else "eigh"
    out = tcv.fit_nested_cv(X, Y, n_outer_folds=3, n_inner_folds=3,
                            chunk_length=10, method=method, **kw)
    assert out[0]["solver_paths"]["mode"] == mode
    return out


@pytest.mark.parametrize("mode", ["train_test", "full_cv_fused",
                                  "full_cv_per_fold"])
def test_copy_runs_only_for_returned_weights(monkeypatch, mode):
    """return_weights=False never calls the helper; True calls it once a
    voxel chunk (and fold) and returns a (D, V) array."""
    calls = []

    def counting(dst, src):
        calls.append(dst.shape)
        return copy_to_host(dst, src)

    monkeypatch.setattr(tcv, "copy_to_host", counting)
    _, wt, _ = _fit(mode, False)
    assert wt is None and calls == []
    _, wt, _ = _fit(mode, True)
    assert wt.shape == (6, 9)
    assert calls and all(shape[1] <= 4 for shape in calls)


def _weights_spans(fn):
    with profile():
        profiling.clear_spans()
        fn()
        record = profiling.spans()
    return record, [s for s in record
                    if s["name"] == "litcoder.fit.weights_to_host"]


def test_weights_span_nests_in_the_refit_on_the_cpu():
    record, spans = _weights_spans(lambda: _fit("train_test", True))
    assert len(spans) == 3          # V 9 in chunks of 4
    for s in spans:
        assert record[s["parent"]]["name"] == "litcoder.fit.refit"
        assert s["counts"]["staged"] == 0 and s["counts"]["blocks"] == 1
    assert [s["counts"]["bytes"] for s in spans] == [6 * 4 * 4, 6 * 4 * 4,
                                                     6 * 1 * 4]


# --- on the card: the staging ring -------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("shape", [(4099, 9001), (3, 5)],
                         ids=["over_the_ring", "odd_small"])
def test_staged_copy_equals_the_plain_fetch_on_the_card(shape, card):
    g = torch.Generator(device=card).manual_seed(7)
    src = torch.randn(shape, generator=g, device=card)
    want = src.cpu().numpy()
    out = np.empty(shape, np.float32)
    copy_to_host(out, src)
    np.testing.assert_array_equal(out, want)
    wide = np.zeros((shape[0], shape[1] + 7), np.float32)
    copy_to_host(wide[:, 3:3 + shape[1]], src)
    np.testing.assert_array_equal(wide[:, 3:3 + shape[1]], want)
    assert not wide[:, :3].any() and not wide[:, 3 + shape[1]:].any()


@pytest.mark.card
def test_ring_is_made_once_and_never_grows_on_the_card(card):
    src = torch.randn(4099, 9001, device=card)
    out = np.empty(tuple(src.shape), np.float32)
    seen = []
    for _ in range(3):
        copy_to_host(out, src)
        ring = tdev._staging_rings[src.device]
        seen.append((id(ring), [s.data_ptr() for s in ring.slots],
                     [s.numel() for s in ring.slots]))
    assert len(tdev._staging_rings) == 1
    assert seen[0] == seen[1] == seen[2]
    assert seen[0][2] == [tdev.STAGING_SLOT_BYTES] * 2
    assert all(s.is_pinned() for s in ring.slots)


@pytest.mark.card
def test_weights_span_counts_on_the_card(card):
    src = torch.randn(4099, 9001, device=card)
    out = np.empty(tuple(src.shape), np.float32)
    _, spans = _weights_spans(lambda: tcv._weights_to_host(out, src))
    rows_a_block = tdev.STAGING_SLOT_BYTES // 4 // 9001
    assert len(spans) == 1
    assert spans[0]["counts"] == {
        "bytes": 4099 * 9001 * 4, "staged": 1,
        "blocks": -(-4099 // rows_a_block)}
    np.testing.assert_array_equal(out, src.cpu().numpy())
