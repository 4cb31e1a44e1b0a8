"""Port parity for the activation caches: litcoder_core_torch.utils.caches
against litcoder_core_tpu.utils.caches. The same parameters give the same
keys in both packages, a cache written by either loads in the other with
equal arrays and metadata, and the factory's language-model path serves a
hit without running the model."""

import pickle

import numpy as np
import pytest
import torch

from litcoder_core_torch.utils import caches as port
from litcoder_core_tpu.utils import caches as jax_caches

torch.set_num_threads(2)

KEY_PARAMS = dict(story="s1", lookback=256, model_name="gpt2",
                  context_type="fullcontext", last_token=True,
                  dataset_type="lebel", raw=True)


def _layers(seed, n=3, shape=(10, 4)):
    rng = np.random.default_rng(seed)
    return {i: rng.normal(size=shape).astype(np.float32) for i in range(n)}


@pytest.mark.parametrize("extra", [{}, {"dtype": "bfloat16"}])
def test_same_keys_as_jax(tmp_path, extra):
    a = port.ActivationCache(str(tmp_path / "t"))
    b = jax_caches.ActivationCache(str(tmp_path / "j"))
    key = a._get_cache_key(**KEY_PARAMS, **extra)
    assert key == b._get_cache_key(**KEY_PARAMS, **extra)
    assert (key == a._get_cache_key(**KEY_PARAMS)) == (not extra)
    speech = dict(audio_id="/x/y.wav", model_name="whisper-tiny",
                  chunk_size=0.1, context_size=16.0, pool="last",
                  target_sample_rate=16000, dataset_type="lebel",
                  extra={"layer_mode": "all", **extra})
    assert (port.SpeechActivationCache(str(tmp_path / "st")).get_cache_key(
        **speech) == jax_caches.SpeechActivationCache(
        str(tmp_path / "sj")).get_cache_key(**speech))


@pytest.mark.parametrize("writer,reader", [(jax_caches, port),
                                           (port, jax_caches)])
def test_caches_cross_packages(tmp_path, writer, reader):
    layers = _layers(1)
    meta = {"model_name": "gpt2", "context_type": "fullcontext",
            "available_layers": [0, 1, 2]}
    w = writer.ActivationCache(str(tmp_path))
    key = w._get_cache_key(**KEY_PARAMS)
    w.save_multi_layer_activations(key, layers, meta)
    w.save_activations(key, layers[0])

    r = reader.ActivationCache(str(tmp_path))
    lazy = r.load_multi_layer_activations(r._get_cache_key(**KEY_PARAMS))
    assert isinstance(lazy, reader.LazyLayerCache)
    assert lazy.get_available_layers() == [0, 1, 2]
    assert lazy.get_metadata() == meta
    for i in layers:
        np.testing.assert_array_equal(lazy.get_layer(i), layers[i])
    assert lazy.get_layers([2, 0])[0] is lazy.get_layer(2)
    lazy.validate_context_type("fullcontext")
    with pytest.raises(ValueError, match="context_type mismatch"):
        lazy.validate_context_type("nocontext")
    with pytest.raises(ValueError, match="not found in cache"):
        lazy.get_layer(99)
    np.testing.assert_array_equal(r.load_activations(key), layers[0])
    assert r.load_multi_layer_activations("nope") is None
    assert r.load_activations("nope") is None


@pytest.mark.parametrize("writer,reader", [(jax_caches, port),
                                           (port, jax_caches)])
def test_speech_caches_cross_packages(tmp_path, writer, reader):
    params = dict(audio_id="/x/y.wav", model_name="whisper-tiny",
                  chunk_size=0.1, context_size=16.0, pool="last",
                  target_sample_rate=16000, dataset_type="lebel",
                  extra={"layer_mode": "all"})
    layers = _layers(2, 2, (7, 6))
    times = np.linspace(16, 20, 7)
    meta = {"model_name": "whisper-tiny", "chunk_size": 0.1,
            "context_size": 16.0, "pool": "last",
            "target_sample_rate": 16000, "dataset_type": "lebel"}
    w = writer.SpeechActivationCache(str(tmp_path))
    w.save_multi_layer_activations(w.get_cache_key(**params), layers, meta,
                                   times=times)
    r = reader.SpeechActivationCache(str(tmp_path))
    key = r.get_cache_key(**params)
    lazy = r.load_multi_layer_activations(key)
    assert isinstance(lazy, reader.SpeechLazyLayerCache)
    np.testing.assert_array_equal(lazy.get_times(), times)
    np.testing.assert_array_equal(lazy.get_layer(1), layers[1])
    assert lazy.get_metadata() == meta
    lazy.validate_params(expected={"model_name": "whisper-tiny",
                                   "pool": "last"})
    with pytest.raises(ValueError, match="parameter mismatch"):
        lazy.validate_params(expected={"pool": "mean"})
    w.save_activations(key, layers[0])
    np.testing.assert_array_equal(r.load_activations(key), layers[0])


def test_legacy_pickle_caches(tmp_path):
    layers = _layers(3)
    blob = {"metadata": {"context_type": "fullcontext"}, "layers": layers,
            "times": np.arange(10.0)}
    with open(tmp_path / "abc.pkl", "wb") as f:
        pickle.dump(blob, f)
    found = port.ActivationCache(str(tmp_path)).load_multi_layer_activations(
        "abc")
    assert found.get_available_layers() == [0, 1, 2]
    np.testing.assert_array_equal(found.get_layer(2), layers[2])
    assert found.get_metadata() == {"context_type": "fullcontext"}
    speech = port.SpeechLazyLayerCache(tmp_path / "abc.pkl")
    np.testing.assert_array_equal(speech.get_times(), np.arange(10.0))
    with open(tmp_path / "single.pkl", "wb") as f:
        pickle.dump(layers[1], f)
    np.testing.assert_array_equal(
        port.ActivationCache(str(tmp_path)).load_activations("single"),
        layers[1])
    with pytest.raises(FileNotFoundError):
        port.LazyLayerCache(tmp_path / "missing.npz").get_metadata()


class _Assembly:
    def __init__(self, texts):
        self.texts = texts

    def get_stimuli(self):
        return [self.texts]


class _CountingModel(torch.nn.Module):
    """A two-block stand-in with the call surface of an HF model; counts
    its forwards."""

    class config:
        model_type = "gpt2"
        n_embd = 4
        n_layer = 2

    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Embedding(600, 4)
        self.calls = 0

    def forward(self, input_ids, attention_mask, output_hidden_states):
        self.calls += 1
        h = self.emb(input_ids)

        class Out:
            hidden_states = (h, 2 * h, 3 * h)

        return Out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_factory_serves_lm_cache_hits(tmp_path, dtype):
    """A miss extracts and caches all layers under the JAX package's key;
    a hit, from the port or from a cache the JAX package wrote, runs no
    forward."""
    from litcoder_core_torch.features.factory import FeatureExtractorFactory
    from litcoder_core_torch.utils.testing import HashStubTokenizer

    model = _CountingModel()
    cache_dir = str(tmp_path / "cache")
    ex = FeatureExtractorFactory.create_extractor(
        "language_model", "counting",
        {"model": model, "tokenizer": HashStubTokenizer(), "device": "cpu",
         "dtype": dtype}, cache_dir=cache_dir)
    assert ex.cache_dir == cache_dir
    assert isinstance(ex.activation_cache, port.ActivationCache)
    asm = _Assembly(["a", "a b", "a b c", "a b c d", "x y", ""])
    miss = FeatureExtractorFactory.extract_features_with_caching(
        ex, asm, "story", 0, layer_idx=1, lookback=16, dataset_type="lebel")
    calls = model.calls if dtype == "float32" else ex._compute_model.calls
    assert calls > 0 and miss.shape == (6, 4) and not miss[5].any()

    params = dict(story="story", lookback=16, model_name="counting",
                  context_type="fullcontext", last_token=True,
                  dataset_type="lebel", raw=True)
    if dtype != "float32":
        params["dtype"] = dtype
    key = jax_caches.ActivationCache(cache_dir)._get_cache_key(**params)
    lazy = jax_caches.ActivationCache(cache_dir).load_multi_layer_activations(
        key)
    assert lazy is not None and lazy.get_available_layers() == [0, 1]
    np.testing.assert_array_equal(lazy.get_layer(1), miss)
    assert lazy.get_metadata()["hook_type"] == "hook_resid_pre"

    hit = FeatureExtractorFactory.extract_features_with_caching(
        ex, asm, "story", 0, layer_idx=0, lookback=16, dataset_type="lebel")
    assert (model.calls if dtype == "float32"
            else ex._compute_model.calls) == calls
    np.testing.assert_array_equal(hit, lazy.get_layer(0))

    # A cache the JAX package wrote under another story name is served.
    jkey = jax_caches.ActivationCache(cache_dir)._get_cache_key(
        **dict(params, story="jax-story"))
    layers = _layers(7, 2, (6, 4))
    jax_caches.ActivationCache(cache_dir).save_multi_layer_activations(
        jkey, layers, {"context_type": "fullcontext"})
    got = FeatureExtractorFactory.extract_features_with_caching(
        ex, asm, "jax-story", 0, layer_idx=1, lookback=16,
        dataset_type="lebel")
    np.testing.assert_array_equal(got, layers[1])
    assert (model.calls if dtype == "float32"
            else ex._compute_model.calls) == calls
