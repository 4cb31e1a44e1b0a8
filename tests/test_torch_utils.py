"""Port parity for the small public names of ported modules: the column
helpers of utils/core.py, FIR.summary, ModelSaver.list_runs, the profiler
trace and annotate of utils/profiling.py, and the word2vec/GloVe readers of
features/embeddings.py, each against its JAX twin (the cases of
tests/test_utils_core.py, tests/test_caches_saver.py and
tests/test_features.py)."""

import gzip
import json
import pickle
import struct

import numpy as np
import pytest
import torch

from litcoder_core_torch import utils as port
from litcoder_core_torch.features.embeddings import (
    SimpleKeyedVectors,
    StaticEmbeddingFeatureExtractor,
)
from litcoder_core_torch.features.fir_expander import FIR
from litcoder_core_torch.utils.saver import ModelSaver
from litcoder_core_tpu import utils as jax_utils

torch.set_num_threads(2)

rng = np.random.default_rng(16)


@pytest.mark.parametrize("name", ["demean", "dm", "zscore", "zs", "rescale",
                                  "rs"])
def test_column_helpers_match_jax(name):
    x = np.column_stack([rng.normal(size=(30, 3)) + 5, np.full(30, 3.0)])
    if name in ("rescale", "rs"):
        x = x[:, :3]
    np.testing.assert_array_equal(getattr(port, name)(x.copy()),
                                  getattr(jax_utils, name)(x.copy()))
    v = rng.normal(size=7)
    np.testing.assert_array_equal(getattr(port, name)(v.copy()),
                                  getattr(jax_utils, name)(v.copy()))


def test_correlations_and_unmask_match_jax():
    a, b = rng.normal(size=(50, 3)), rng.normal(size=(50, 3))
    np.testing.assert_array_equal(port.mcorr(a, b), jax_utils.mcorr(a, b))
    np.testing.assert_allclose(port.mcorr(a, a), 1.0, atol=1e-5)
    c, d = rng.normal(size=(4, 100)), rng.normal(size=(6, 100))
    assert port.xcorr(c, d).shape == (4, 6)
    np.testing.assert_array_equal(port.xcorr(c, d), jax_utils.xcorr(c, d))
    got = port.unmask_correlations_for_plotting(np.array([0.5, 0.7]),
                                                np.array([1, 3]), 5)
    want = jax_utils.unmask_correlations_for_plotting(
        np.array([0.5, 0.7]), np.array([1, 3]), 5)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0]) and got[1] == 0.5


@pytest.mark.parametrize("delays,circpad", [([1, 2, 3], False),
                                            ([-1, 0, 2], True)])
def test_make_delayed_and_fir_summary_match_jax(delays, circpad):
    from litcoder_core_tpu.features.fir_expander import FIR as JaxFIR

    stim = rng.normal(size=(12, 4)).astype(np.float32)
    got = port.make_delayed(stim, delays, circpad)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(
        got.numpy(), jax_utils.make_delayed(stim, delays, circpad))
    for args in ((), (4,), (None, 12), (4, 12)):
        assert (FIR(delays, circpad).summary(*args)
                == JaxFIR(delays, circpad).summary(*args))


def test_list_runs_matches_jax(tmp_path):
    from litcoder_core_tpu.utils.saver import ModelSaver as JaxSaver

    saver = ModelSaver(str(tmp_path))
    run = saver.save_encoding_model(torch.zeros(2, 2), torch.ones(2),
                                    {"layer_idx": 9}, {"median_score": 0.5})
    for t in ["20260816_090000", "20260816_110000", "20260816_100000"]:
        d = tmp_path / f"run_{t}_abcd1234"
        d.mkdir()
        (d / "hyperparams.json").write_text(json.dumps({"t": t}))
        with open(d / "metrics.pkl", "wb") as f:
            pickle.dump({}, f)
    (tmp_path / "run_broken").mkdir()  # no files: logged and skipped
    got, want = saver.list_runs(), JaxSaver(str(tmp_path)).list_runs()
    assert got == want
    assert [r["timestamp"] for r in got][1:] == [
        "20260816_110000", "20260816_100000", "20260816_090000"]
    assert got[0]["run_dir"] == str(run)
    assert got[0]["hyperparams"] == {"layer_idx": 9}


def test_trace_writes_a_profile(tmp_path):
    x = torch.ones(64, 64)
    with port.trace(str(tmp_path / "prof"), create_perfetto_link=True):
        with port.annotate("port-region"):
            (x @ x).sum()
    (path,) = list((tmp_path / "prof").glob("trace_*.json"))
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "port-region" for e in events)
    timer = port.StageTimer()
    with timer.stage("a"):
        pass
    assert set(timer.report()) == {"a"}


def _vectors(tmp_path, kind):
    """(path, expected words, expected vectors) of one vectors file."""
    words = ["foo", "bar", "baz"]
    vecs = np.arange(9, dtype=np.float32).reshape(3, 3) / 4
    if kind in ("bin", "bin.gz"):
        path = tmp_path / f"v.{kind}"
        payload = b"3 3\n" + b"".join(w.encode() + b" " + struct.pack(
            "<3f", *v) + b"\n" for w, v in zip(words, vecs))
        path.write_bytes(gzip.compress(payload) if kind.endswith("gz")
                         else payload)
        return path, words, vecs
    lines = [f"{w} " + " ".join(str(x) for x in v)
             for w, v in zip(words, vecs)]
    if kind == "w2v.txt":
        lines.insert(0, "3 3")
    path = tmp_path / f"v.{kind}"
    text = "\n".join(lines) + "\n"
    if kind.endswith("gz"):
        path.write_bytes(gzip.compress(text.encode()))
    else:
        path.write_text(text)
    return path, words, vecs


@pytest.mark.parametrize("kind", ["w2v.txt", "txt", "txt.gz", "bin",
                                  "bin.gz"])
def test_word2vec_and_glove_files_match_jax(tmp_path, kind):
    from litcoder_core_tpu.features.embeddings import (
        StaticEmbeddingFeatureExtractor as JaxEmb,
    )

    path, words, vecs = _vectors(tmp_path, kind)
    cfg = {"vector_path": str(path), "lowercase": False}
    ex = StaticEmbeddingFeatureExtractor(dict(cfg))
    assert ex.kv.index_to_key == words
    np.testing.assert_array_equal(ex.kv.vectors, vecs)
    tokens = ["bar", "nope", "foo"]
    np.testing.assert_array_equal(ex.extract_features(tokens),
                                  JaxEmb(dict(cfg)).extract_features(tokens))
    np.testing.assert_array_equal(ex.extract_features("foo baz"), vecs[[0, 2]])


def test_vector_format_flags_and_errors(tmp_path):
    # A GloVe file named like word2vec text: the header guess fails, the
    # retry without it succeeds, as in JAX.
    glove = tmp_path / "g.txt"
    glove.write_text("foo 1.0 2.0\nbar 3.0 4.0\n")
    ex = StaticEmbeddingFeatureExtractor({"vector_path": str(glove),
                                          "no_header": False})
    np.testing.assert_array_equal(ex.extract_features("foo bar"),
                                  [[1, 2], [3, 4]])
    path, words, vecs = _vectors(tmp_path, "bin")
    renamed = tmp_path / "vectors.dat"
    renamed.write_bytes(path.read_bytes())
    ex = StaticEmbeddingFeatureExtractor({"vector_path": str(renamed),
                                          "binary": True})
    np.testing.assert_array_equal(ex.kv.vectors, vecs)
    trunc = tmp_path / "trunc.bin"
    trunc.write_bytes(b"5 4\nonly " + struct.pack("<4f", 1, 2, 3, 4))
    with pytest.raises(ValueError, match="truncated"):
        SimpleKeyedVectors.load_word2vec_format(str(trunc), binary=True)
