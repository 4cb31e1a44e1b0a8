"""Port parity for the speech extractor: the port's SpeechFeatureExtractor
on torch encoders (CPU) against the JAX extractor on the same audio and
weights, at the JAX package's cross-backend bar (atol 1e-4,
tests/test_cross_backend_parity.py).

- Wav2Vec2 with stable layer norm (feat_extract_norm='layer'): the JAX
  extractor's Flax path; the port's torch twin gets the Flax weights through
  features.convert.torch_state_dict_from_flax. Hidden width 24 against a
  positional convolution of 16 taps, so a transposed `weight_v` cannot load.
- Wav2Vec2 with group norm (wav2vec2-base's variant) and HuBERT: Flax has
  neither, so the JAX extractor's backend='torch' path on the same module.
  Their positional convolution has 12 taps: torch 2.13's CPU bf16 grouped
  conv1d is wrong at 8 and 16 taps (relative error above 1), which the bf16
  test would otherwise measure.
- Whisper through get_encoder(), tiny WhisperConfig Flax weights.
Also the windows and times, load_audio, the errors, bf16 against fp32, the
factory's speech cache in both directions and the precision scope that
keeps cuDNN convolutions out of TF32."""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from litcoder_core_torch.features import speech_model as port_speech
from litcoder_core_torch.features.convert import torch_state_dict_from_flax
from litcoder_core_torch.features.factory import FeatureExtractorFactory
from litcoder_core_torch.utils import device as tdevice

torch.set_num_threads(2)

ATOL = 1e-4
SR = 16000
COMMON = dict(model_name="tiny-speech", chunk_size=0.5, context_size=1.0,
              target_sample_rate=SR)
SMALL = dict(hidden_size=24, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=32, conv_dim=(8, 8), conv_kernel=(10, 3),
             conv_stride=(5, 2), num_feat_extract_layers=2,
             num_conv_pos_embedding_groups=2)


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    """3 s of seeded 16 kHz audio: five windows of 1 s at 0.5 s strides."""
    rng = np.random.default_rng(14)
    path = str(tmp_path_factory.mktemp("audio") / "story.wav")
    wavfile.write(path, SR, (0.1 * rng.normal(size=3 * SR)).astype(np.float32))
    return path


@pytest.fixture(scope="module")
def w2v2_pair():
    """(Flax model, torch twin, feature extractor), stable layer norm."""
    from transformers import (
        FlaxWav2Vec2Model,
        Wav2Vec2Config,
        Wav2Vec2FeatureExtractor,
        Wav2Vec2Model,
    )

    cfg = Wav2Vec2Config(num_conv_pos_embeddings=16,
                         do_stable_layer_norm=True, feat_extract_norm="layer",
                         **SMALL)
    fm = FlaxWav2Vec2Model(cfg, seed=0)
    tm = Wav2Vec2Model(cfg)
    tm.load_state_dict(torch_state_dict_from_flax(fm.params))
    return fm, tm, Wav2Vec2FeatureExtractor()


@pytest.fixture(scope="module")
def torch_encoders():
    """{'group': Wav2Vec2 with group norm, 'hubert': HuBERT}, random init
    under torch.manual_seed(0)."""
    from transformers import HubertConfig, HubertModel, Wav2Vec2Config
    from transformers import Wav2Vec2Model

    torch.manual_seed(0)
    group = Wav2Vec2Model(Wav2Vec2Config(
        num_conv_pos_embeddings=12, do_stable_layer_norm=False,
        feat_extract_norm="group", **SMALL))
    hubert = HubertModel(HubertConfig(num_conv_pos_embeddings=12, **SMALL))
    return {"group": group.eval(), "hubert": hubert.eval()}


@pytest.fixture(scope="module")
def whisper_pair():
    from transformers import (
        FlaxWhisperModel,
        WhisperConfig,
        WhisperFeatureExtractor,
        WhisperModel,
    )

    cfg = WhisperConfig(
        vocab_size=100, num_mel_bins=16, d_model=24, encoder_layers=2,
        encoder_attention_heads=2, encoder_ffn_dim=32, decoder_layers=1,
        decoder_attention_heads=2, decoder_ffn_dim=32,
        max_source_positions=50, max_target_positions=16, pad_token_id=0,
        bos_token_id=1, eos_token_id=2, decoder_start_token_id=1,
        begin_suppress_tokens=None, suppress_tokens=None)
    fm = FlaxWhisperModel(cfg, seed=0, input_shape=(1, 16, 100))
    tm = WhisperModel(cfg)
    tm.load_state_dict(torch_state_dict_from_flax(fm.params))
    # One-second log-mel frames: 100, what max_source_positions=50 takes.
    return fm, tm, WhisperFeatureExtractor(feature_size=16, chunk_length=1)


def _jax(model, feature_extractor, **kw):
    from litcoder_core_tpu.features.speech_model import SpeechFeatureExtractor

    return SpeechFeatureExtractor(**dict(COMMON, model=model,
                                         feature_extractor=feature_extractor,
                                         batch_size=8, **kw))


def _port(model, feature_extractor, **kw):
    return port_speech.SpeechFeatureExtractor(
        **dict(COMMON, model=model, feature_extractor=feature_extractor,
               device="cpu", batch_size=2, **kw))


@pytest.fixture(scope="module")
def jax_w2v2_layers(w2v2_pair, wav_path):
    """The JAX extractor's Flax features per pool."""
    cache = {}

    def get(pool):
        if pool not in cache:
            fm, _, fe = w2v2_pair
            cache[pool] = _jax(fm, fe, pool=pool,
                               backend="flax").extract_all_layers(wav_path)
        return cache[pool]

    return get


def _assert_layers_equal(got, want, atol=ATOL):
    (gl, gt), (wl, wt) = got, want
    np.testing.assert_array_equal(gt, wt)
    assert set(gl) == set(wl) == {0, 1}
    for layer in wl:
        assert gl[layer].dtype == np.float32
        assert gl[layer].shape == wl[layer].shape == (5, 24)
        np.testing.assert_allclose(gl[layer], wl[layer], atol=atol,
                                   err_msg=f"layer {layer}")


def test_state_dicts_equal_transformers_loader(w2v2_pair, whisper_pair):
    from transformers import Wav2Vec2Model, WhisperModel
    from transformers.modeling_flax_pytorch_utils import (
        load_flax_weights_in_pytorch_model,
    )

    for (fm, _, _), cls in ((w2v2_pair, Wav2Vec2Model),
                            (whisper_pair, WhisperModel)):
        want = load_flax_weights_in_pytorch_model(cls(fm.config),
                                                  fm.params).state_dict()
        got = torch_state_dict_from_flax(fm.params)
        assert set(got) == set(want)
        for key in want:
            assert got[key].shape == want[key].shape, key
            assert torch.equal(got[key], want[key]), key
    g = torch_state_dict_from_flax(w2v2_pair[0].params)
    prefix = "encoder.pos_conv_embed.conv.parametrizations.weight."
    assert tuple(g[prefix + "original0"].shape) == (1, 1, 16)
    assert tuple(g[prefix + "original1"].shape) == (24, 12, 16)


@pytest.mark.parametrize("pool", ["last", "mean"])
def test_wav2vec2_layer_norm_matches_jax_flax(w2v2_pair, wav_path,
                                              jax_w2v2_layers, pool):
    _, tm, fe = w2v2_pair
    ex = _port(tm, fe, pool=pool)
    _assert_layers_equal(ex.extract_all_layers(wav_path),
                         jax_w2v2_layers(pool))
    assert ex.counts == {"windows": 5, "forwards": 3}
    assert set(ex.last_stage_seconds) == {"load_s", "prepare_s",
                                          "fetch_wait_s", "forward_total_s"}


@pytest.mark.parametrize("pool", ["last", "mean"])
def test_wav2vec2_group_norm_matches_jax_torch_path(torch_encoders, w2v2_pair,
                                                    wav_path, pool):
    model, fe = torch_encoders["group"], w2v2_pair[2]
    want = _jax(model, fe, pool=pool,
                backend="torch").extract_all_layers(wav_path)
    _assert_layers_equal(_port(model, fe, pool=pool).extract_all_layers(
        wav_path), want)


def test_hubert_matches_jax_torch_path(torch_encoders, w2v2_pair, wav_path):
    model, fe = torch_encoders["hubert"], w2v2_pair[2]
    want = _jax(model, fe, backend="torch").extract_all_layers(wav_path)
    _assert_layers_equal(_port(model, fe).extract_all_layers(wav_path), want)


def test_whisper_encoder_matches_jax_flax(whisper_pair, wav_path):
    fm, tm, fe = whisper_pair
    want = _jax(fm, fe, backend="flax").extract_all_layers(wav_path)
    ex = _port(tm, fe)
    assert ex.model_type == "whisper" and ex._forward_key == "input_features"
    _assert_layers_equal(ex.extract_all_layers(wav_path), want)


def test_single_layer_matches_all_layers(w2v2_pair, wav_path):
    _, tm, fe = w2v2_pair
    ex = _port(tm, fe)
    layers, times = ex.extract_all_layers(wav_path)
    for layer, want in (("last", layers[1]), (0, layers[0]), (1, layers[1])):
        got, got_times = ex.extract_features(wav_path, layer=layer)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_times, times)
    np.testing.assert_array_equal(_port(tm, fe, layer=0).extract_features(
        wav_path)[0], layers[0])


def test_windows_and_times_match_jax(w2v2_pair):
    from litcoder_core_tpu.features.speech_model import (
        SpeechFeatureExtractor as JaxSpeech,
    )

    _, tm, fe = w2v2_pair
    wav = np.arange(1000, dtype=np.float32)
    for chunk, context, sr in ((0.5, 2.0, 100), (0.1, 1.0, 160),
                               (0.3, 9.99, 100)):
        port = _port(tm, fe, chunk_size=chunk, context_size=context,
                     target_sample_rate=sr)
        ref = object.__new__(JaxSpeech)
        ref.chunk_size, ref.context_size = chunk, context
        ref.target_sample_rate = sr
        got, want = port._windows(wav), JaxSpeech._windows(ref, wav)
        assert got[0].base is not None  # a strided view, not a copy
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == want[1].dtype == np.float64


def test_audio_shorter_than_context(w2v2_pair, tmp_path):
    fm, tm, fe = w2v2_pair
    path = str(tmp_path / "short.wav")
    wavfile.write(path, SR, np.zeros(SR // 4, np.float32))
    ex = _port(tm, fe)
    windows, times = ex._windows(np.zeros(SR // 4, np.float32))
    assert windows.shape == (0, 0) and times.shape == (0,)
    layers, times = ex.extract_all_layers(path)
    assert layers == {} and len(times) == 0
    feats, times = ex.extract_features(path)
    assert feats.shape == (0, 0) and len(times) == 0
    assert _jax(fm, fe).extract_all_layers(path)[0] == {}


def test_errors_match_jax(w2v2_pair):
    from litcoder_core_tpu.features.speech_model import (
        SpeechFeatureExtractor as JaxSpeech,
    )

    _, tm, fe = w2v2_pair
    for bad, match in (({"pool": "max"}, "pool must be"),
                       ({"dtype": "float16"}, "dtype")):
        for cls in (JaxSpeech, port_speech.SpeechFeatureExtractor):
            with pytest.raises(ValueError, match=match):
                cls(**dict(COMMON, model=object(), feature_extractor=object(),
                           **bad))
    with pytest.raises(ValueError, match="torch models"):
        _port(tm, fe, backend="flax")
    # The mesh is ported (tests/test_torch_tp.py); these are its guards.
    from litcoder_core_torch.parallel.mesh import make_mesh
    from litcoder_core_torch.parallel.tp import make_lm_mesh

    with pytest.raises(TypeError, match="Mesh"):
        _port(tm, fe, mesh=object())
    with pytest.raises(ValueError, match="axes"):
        _port(tm, fe, mesh=make_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="mesh's devices"):
        _port(tm, fe, mesh=make_lm_mesh(1, 2, devices=["cuda:0"] * 2))


@pytest.mark.parametrize("pool", ["last", "mean"])
def test_bf16_close_to_fp32(torch_encoders, w2v2_pair, wav_path, pool):
    """dtype='bfloat16' runs on a bf16 copy of the weights, returns float32
    and stays within tests/test_speech.py's bound of the fp32 features."""
    model, fe = torch_encoders["group"], w2v2_pair[2]
    f32, t32 = _port(model, fe, pool=pool).extract_all_layers(wav_path)
    ex = _port(model, fe, pool=pool, dtype="bfloat16")
    b16, t16 = ex.extract_all_layers(wav_path)
    assert next(ex._compute_model.parameters()).dtype == torch.bfloat16
    assert next(model.parameters()).dtype == torch.float32
    np.testing.assert_array_equal(t32, t16)
    for layer in f32:
        assert b16[layer].dtype == np.float32
        rel = (np.linalg.norm(f32[layer] - b16[layer])
               / max(np.linalg.norm(f32[layer]), 1e-6))
        assert rel < 0.06, (layer, rel)


@pytest.mark.parametrize("kind", ["int16", "uint8", "stereo", "float32",
                                  "22050 Hz"])
def test_load_audio_matches_jax(tmp_path, kind):
    from litcoder_core_tpu.features.speech_model import load_audio

    rng = np.random.default_rng(3)
    x = 0.1 * rng.normal(size=SR)
    sr = SR
    data = {
        "int16": (x * 32767).astype(np.int16),
        "uint8": np.clip(x * 127 + 128, 0, 255).astype(np.uint8),
        "stereo": (np.stack([x, -0.5 * x], axis=1) * 32767).astype(np.int16),
        "float32": x.astype(np.float32),
        "22050 Hz": x.astype(np.float32),
    }[kind]
    if kind == "22050 Hz":
        sr = 22050
    path = str(tmp_path / "a.wav")
    wavfile.write(path, sr, data)
    got = port_speech.load_audio(path, SR)
    want = load_audio(path, SR)
    assert got.dtype == np.float32 and got.ndim == 1
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() <= 1.0
    if kind == "22050 Hz":
        assert abs(len(got) - round(SR * SR / 22050)) <= 1


class OneStory:
    """The one assembly method the speech path reads: a story's audio."""

    def __init__(self, path):
        self.path = path

    def get_audio_path(self):
        return [self.path]


def test_factory_speech_cache_both_ways(w2v2_pair, wav_path, tmp_path):
    """Each package's speech cache entry serves the other: the same key,
    layers and times, and no forward on the hit."""
    from litcoder_core_tpu.features.factory import (
        FeatureExtractorFactory as JaxFactory,
    )

    fm, tm, fe = w2v2_pair
    asm = OneStory(wav_path)
    config = dict(COMMON, feature_extractor=fe, batch_size=2)
    for writer, reader in (("port", "jax"), ("jax", "port")):
        cache_dir = str(tmp_path / f"{writer}_writes")
        made = {
            "port": lambda: FeatureExtractorFactory.create_extractor(
                "speech", "tiny-speech", dict(config, model=tm,
                                              device="cpu"),
                cache_dir=cache_dir),
            "jax": lambda: JaxFactory.create_extractor(
                "speech", "tiny-speech", dict(config, model=fm),
                cache_dir=cache_dir),
        }
        factory = {"port": FeatureExtractorFactory, "jax": JaxFactory}
        ex = made[writer]()
        assert ex.cache_dir == cache_dir
        first = factory[writer]._extract_speech_features(
            ex, asm, "story", 0, 1, "narratives")
        reader_ex = made[reader]()
        if reader == "port":
            reader_ex._run_all = None  # a hit must not extract
        second = factory[reader]._extract_speech_features(
            reader_ex, asm, "story", 0, 1, "narratives")
        np.testing.assert_array_equal(second[0], first[0])
        np.testing.assert_array_equal(second[1], first[1])
        assert len(list((tmp_path / f"{writer}_writes").glob("*.npz"))) == 1


def test_factory_speech_cache_keys_and_validation(w2v2_pair, wav_path,
                                                  tmp_path):
    """bf16 features key separately from fp32 ones; a cached entry whose
    metadata disagrees with the extractor raises, in both packages."""
    from litcoder_core_tpu.features.factory import (
        FeatureExtractorFactory as JaxFactory,
    )
    from litcoder_core_tpu.utils.caches import (
        SpeechActivationCache as JaxSpeechCache,
    )

    _, tm, fe = w2v2_pair
    asm = OneStory(wav_path)
    exs = [FeatureExtractorFactory.create_extractor(
        "speech", "tiny-speech", dict(COMMON, model=tm, feature_extractor=fe,
                                      device="cpu", dtype=dtype),
        cache_dir=str(tmp_path / "keys")) for dtype in ("float32",
                                                        "bfloat16")]
    for ex in exs:
        FeatureExtractorFactory._extract_speech_features(ex, asm, "s", 0, 0,
                                                         "lebel")
    assert len(list((tmp_path / "keys").glob("*.npz"))) == 2

    bad_dir = tmp_path / "bad"
    ex = exs[0]
    key = ex.speech_cache.get_cache_key(
        audio_id=wav_path, model_name=ex.model_name,
        chunk_size=ex.chunk_size, context_size=ex.context_size, pool=ex.pool,
        target_sample_rate=ex.target_sample_rate, dataset_type="lebel",
        extra={"layer_mode": "all"})
    JaxSpeechCache(str(bad_dir)).save_multi_layer_activations(
        key, {0: np.zeros((5, 24), np.float32)},
        {"model_name": "another-model"}, times=np.arange(5.0))
    for factory, cache_cls in ((FeatureExtractorFactory,
                                type(ex.speech_cache)),
                               (JaxFactory, JaxSpeechCache)):
        ex.speech_cache = cache_cls(str(bad_dir))
        with pytest.raises(ValueError, match="parameter mismatch"):
            factory._extract_speech_features(ex, asm, "s", 0, 0, "lebel")


def _conv_flag():
    return torch.backends.cudnn.conv.fp32_precision


def test_precision_scope_covers_cudnn_convolutions():
    """matmul_conv_tf32 sets both flags inside the scope and gives the
    caller's back after it, also when the body raises."""
    conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    saved = (conv.fp32_precision, mm.fp32_precision)
    try:
        conv.fp32_precision, mm.fp32_precision = "tf32", "none"
        with tdevice.matmul_conv_tf32(False):
            assert (_conv_flag(), mm.fp32_precision) == ("ieee", "ieee")
            with tdevice.matmul_conv_tf32(True):
                assert (_conv_flag(), mm.fp32_precision) == ("tf32", "tf32")
            assert (_conv_flag(), mm.fp32_precision) == ("ieee", "ieee")
        assert (_conv_flag(), mm.fp32_precision) == ("tf32", "none")
        with pytest.raises(RuntimeError, match="boom"):
            with tdevice.matmul_conv_tf32(False):
                assert _conv_flag() == "ieee"
                raise RuntimeError("boom")
        assert (_conv_flag(), mm.fp32_precision) == ("tf32", "none")
        # matmul_tf32 (the fit's scope) leaves convolutions alone.
        with tdevice.matmul_tf32(False):
            assert (_conv_flag(), mm.fp32_precision) == ("tf32", "ieee")
    finally:
        conv.fp32_precision, mm.fp32_precision = saved


def test_extractor_forward_runs_inside_the_scope(w2v2_pair, wav_path,
                                                 monkeypatch):
    """The encoder runs with convolutions and matmuls at full fp32."""
    _, tm, fe = w2v2_pair
    ex = _port(tm, fe)
    seen = []
    encoder = ex._encoder

    def spy(**kw):
        seen.append((_conv_flag(), torch.backends.cuda.matmul.fp32_precision))
        return encoder(**kw)

    monkeypatch.setattr(ex, "_encoder", spy)
    before = _conv_flag()
    ex.extract_all_layers(wav_path)
    assert seen and set(seen) == {("ieee", "ieee")}
    assert _conv_flag() == before
