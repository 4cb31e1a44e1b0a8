"""Port parity for tensor-parallel extraction (parallel/tp.py): the cases
of tests/test_tp.py on the port's torch twins of the same Flax models
(weights carried across by features/convert.py), on ('data', 'model')
meshes of CPU entries. Every TP forward is held to the JAX package's TP
forward on its 8 virtual CPU devices and to the port's unsharded forward,
within 1e-4 (test_tp.py's bar); the CLI's --tp_data 2 --tp_model 4 to
single-device extraction."""

import logging

import numpy as np
import pytest
import torch

from litcoder_core_torch import cli as tcli
from litcoder_core_torch.features import language_model as port_lm
from litcoder_core_torch.features import speech_model as port_speech
from litcoder_core_torch.features.convert import torch_state_dict_from_flax
from litcoder_core_torch.parallel import tp as ttp
from litcoder_core_torch.parallel.mesh import make_mesh
from litcoder_core_torch.utils.testing import HashStubTokenizer
from litcoder_core_tpu.assembly.assembly_loader import save_assembly
from litcoder_core_tpu.parallel import tp as jtp
from tests.test_cli_banded import _assembly_with_audio, _banded_config
from tests.test_torch_language_model import gpt2_pair  # noqa: F401

torch.set_num_threads(2)

ATOL = 1e-4
TEXTS = [
    "hello world",
    "the cat sat on the mat",
    "",
    "one more text here with a few extra tokens to vary length",
    "short",
]


def _lm_mesh(n_data, n_model):
    return ttp.make_lm_mesh(n_data, n_model, device="cpu")


def _jax_lm(fm, mesh=None, **kw):
    from litcoder_core_tpu.features.language_model import (
        LanguageModelFeatureExtractor,
    )

    cfg = {"model_name": "tiny", "model": fm,
           "tokenizer": HashStubTokenizer(), "last_token": True,
           "batch_size": 4, "backend": "flax", **kw}
    if mesh is not None:
        cfg["mesh"] = mesh
    return LanguageModelFeatureExtractor(cfg)


def _port_lm(tm, mesh=None, **kw):
    cfg = {"model_name": "tiny", "model": tm,
           "tokenizer": HashStubTokenizer(), "last_token": True,
           "batch_size": 4, "device": "cpu", **kw}
    if mesh is not None:
        cfg["mesh"] = mesh
    return port_lm.LanguageModelFeatureExtractor(cfg)


def _assert_layers(got, want, ref):
    assert set(got) == set(want) == set(ref)
    for layer in ref:
        np.testing.assert_allclose(got[layer], want[layer], atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_allclose(got[layer], ref[layer], atol=ATOL,
                                   rtol=ATOL)


# ---- placement rules on torch names and layouts -----------------------------

def test_spec_column_parallel_gpt2_conv1d_layout():
    # torch GPT-2 Conv1D weights are (in, out): c_attn (d, 3d), c_fc (d, 4d)
    assert ttp.spec_for_param("h.0.attn.c_attn.weight",
                              (16, 48), 4) == (None, "model")
    assert ttp.spec_for_param("h.0.attn.c_attn.bias", (48,), 4) == ("model",)
    assert ttp.spec_for_param("h.2.mlp.c_fc.weight",
                              (16, 64), 4) == (None, "model")


def test_spec_row_parallel_weight_bias_replicated():
    assert ttp.spec_for_param("h.0.mlp.c_proj.weight",
                              (64, 16), 4) == ("model", None)
    # nn.Linear (out, in) row-parallel shards dim 1
    assert ttp.spec_for_param("model.layers.0.mlp.down_proj.weight",
                              (16, 64), 4) == (None, "model")
    assert ttp.spec_for_param("h.0.mlp.c_proj.bias", (16,), 4) == ()


def test_spec_replicates_embeddings_norms_and_unknown():
    assert ttp.spec_for_param("wte.weight", (600, 16), 4) == ()
    assert ttp.spec_for_param("h.0.ln_1.weight", (16,), 4) == ()
    assert ttp.spec_for_param("some.novel.param.weight", (16, 16), 4) == ()


def test_spec_divisibility_guard_falls_back_to_replicated():
    assert ttp.spec_for_param("h.0.attn.c_attn.weight", (16, 18), 4) == ()


def test_separate_projection_family_names():
    """nn.Linear families: q/k/v and MLP up column-parallel on the OUT dim
    (0), out/down row-parallel on the IN dim (1); a module's own type
    overrides the name's layout (an nn.Linear named c_attn)."""
    for name in ("encoder.layers.0.attention.q_proj.weight",
                 "model.layers.3.self_attn.k_proj.weight",
                 "encoder.layers.1.feed_forward.intermediate_dense.weight",
                 "encoder.layer.0.intermediate.dense.weight",
                 "layers.0.fc1.weight"):
        assert ttp.spec_for_param(name, (32, 16), 4) == ("model", None), name
    for name in ("encoder.layers.0.attention.out_proj.weight",
                 "encoder.layers.1.feed_forward.output_dense.weight",
                 "encoder.layer.0.attention.output.dense.weight",
                 "layers.0.fc2.weight"):
        assert ttp.spec_for_param(name, (16, 32), 4) == (None, "model"), name
    assert ttp.spec_for_param("h.0.attn.c_attn.weight", (48, 16), 4,
                              conv1d=False) == ("model", None)


def test_make_lm_mesh_shapes_and_overflow():
    mesh = ttp.make_lm_mesh(2, 4, devices=["cpu"] * 8)
    assert mesh.shape == dict(jtp.make_lm_mesh(2, 4).shape) == {
        "data": 2, "model": 4}
    assert mesh.devices.shape == (2, 4)
    # Overflow, and a data axis alone larger than the device count (no
    # empty mesh): JAX's texts.
    for args, needs in (((2, 8), 16), ((16,), 16)):
        with pytest.raises(RuntimeError) as want:
            jtp.make_lm_mesh(*args)
        with pytest.raises(RuntimeError) as got:
            ttp.make_lm_mesh(*args, devices=["cpu"] * 8)
        assert str(got.value) == str(want.value)
        assert f"needs {needs} devices but only 8 exist" in str(got.value)
    assert _lm_mesh(2, 4).shape == {"data": 2, "model": 4}


def test_param_shards_shrink_on_model_axis(gpt2_pair, caplog):  # noqa: F811
    fm, tm = gpt2_pair
    with caplog.at_level(logging.INFO, logger="litcoder_core_tpu.parallel.tp"):
        placed = jtp.shard_lm_params(fm.params, jtp.make_lm_mesh(1, 4))
    with caplog.at_level(logging.INFO,
                         logger="litcoder_core_torch.parallel.tp"):
        (copy,) = ttp.shard_lm_params(tm, _lm_mesh(1, 4))
    k = placed["h"]["0"]["attn"]["c_attn"]["kernel"]
    jshapes = {s.data.shape for s in k.addressable_shards}
    c_attn = copy.h[0].attn.c_attn
    # Conv1D (16, 48) column-parallel over 4 -> (16, 12) per shard: the
    # Flax kernel's (12, 16), transposed.
    assert {tuple(w.shape) for w in c_attn.weights} == {(16, 12)}
    assert {s[::-1] for s in jshapes} == {(16, 12)}
    assert {tuple(b.shape) for b in c_attn.biases} == {(12,)}
    assert tuple(copy.wte.weight.shape) == (600, 16)
    assert {tuple(w.shape) for w in copy.h[0].mlp.c_proj.weights} == {
        (16, 16)}
    counts = [r.message.split(": ")[-1] for r in caplog.records
              if "TP placement" in r.message]
    assert len(counts) == 2 and counts[0] == counts[1]
    # The caller's model is not changed.
    assert type(tm.h[0].attn.c_attn).__name__ == "Conv1D"


# ---- numerical parity -------------------------------------------------------

@pytest.fixture(scope="module")
def lm_refs(gpt2_pair):  # noqa: F811
    fm, tm = gpt2_pair
    return {"last": _port_lm(tm).extract_all_layers(TEXTS),
            "mean": _port_lm(tm, last_token=False).extract_all_layers(TEXTS)}


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2)])
def test_tp_forward_matches_unsharded(gpt2_pair, lm_refs,  # noqa: F811
                                      mesh_shape):
    fm, tm = gpt2_pair
    want = _jax_lm(fm, mesh=jtp.make_lm_mesh(*mesh_shape)).extract_all_layers(
        TEXTS)
    got = _port_lm(tm, mesh=_lm_mesh(*mesh_shape)).extract_all_layers(TEXTS)
    _assert_layers(got, want, lm_refs["last"])


def test_tp_with_prefix_chains_matches(gpt2_pair):  # noqa: F811
    fm, tm = gpt2_pair
    words = ("the quick brown fox jumps over the lazy dog again and "
             "again today").split()
    chains = [" ".join(words[: i + 1]) for i in range(len(words))]
    ref = _port_lm(tm, prefix_sharing=True).extract_all_layers(chains)
    want = _jax_lm(fm, mesh=jtp.make_lm_mesh(2, 4),
                   prefix_sharing=True).extract_all_layers(chains)
    ex = _port_lm(tm, mesh=_lm_mesh(2, 4), prefix_sharing=True)
    got = ex.extract_all_layers(chains)
    assert ex.counts["chain_forwards"] >= 1
    _assert_layers(got, want, ref)


def test_tp_mean_pooling_matches(gpt2_pair, lm_refs):  # noqa: F811
    fm, tm = gpt2_pair
    want = _jax_lm(fm, mesh=jtp.make_lm_mesh(4, 2),
                   last_token=False).extract_all_layers(TEXTS)
    got = _port_lm(tm, mesh=_lm_mesh(4, 2),
                   last_token=False).extract_all_layers(TEXTS)
    _assert_layers(got, want, lm_refs["mean"])


def test_tp_bf16_shards_close_to_fp32(gpt2_pair, lm_refs):  # noqa: F811
    """Cast before sharding: a bf16 run holds bf16 shards."""
    _, tm = gpt2_pair
    ex = _port_lm(tm, mesh=_lm_mesh(1, 2), dtype="bfloat16")
    assert ex._tp_models[0].h[0].attn.c_attn.weights[0].dtype == \
        torch.bfloat16
    got = ex.extract_all_layers(TEXTS)
    for layer, ref in lm_refs["last"].items():
        np.testing.assert_allclose(got[layer], ref, atol=0.1 * np.abs(
            ref).max() + 1e-3)


def test_mesh_guards(gpt2_pair):  # noqa: F811
    """The counterpart of test_mesh_requires_flax_backend: the port's only
    backend is torch, so what it refuses is a mesh that is not a
    ('data', 'model') Mesh of the extractor's device type."""
    _, tm = gpt2_pair
    with pytest.raises(TypeError, match="make_lm_mesh"):
        _port_lm(tm, mesh=object())
    with pytest.raises(ValueError, match="axes"):
        _port_lm(tm, mesh=make_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="mesh's devices"):
        _port_lm(tm, mesh=ttp.make_lm_mesh(1, 2, devices=["cuda:0"] * 2))


def test_pad_batch_rows():
    mesh = _lm_mesh(4, 2)
    assert ttp.pad_batch_rows(5, mesh) == 3 == jtp.pad_batch_rows(
        5, jtp.make_lm_mesh(4, 2))
    assert ttp.pad_batch_rows(8, mesh) == 0
    (ids, mask), n_pad = ttp.pad_and_shard(
        (np.ones((5, 3), np.int64), np.ones((5, 3), np.int64)), mesh)
    assert n_pad == 3 and [tuple(b.shape) for b in ids] == [(2, 3)] * 4
    assert int(torch.cat(mask).sum()) == 15  # pad rows carry a zero mask
    with pytest.raises(ValueError, match="does not divide"):
        ttp.shard_batch((np.ones((5, 3)),), mesh)


# ---- speech -----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_speech():
    """(Flax Wav2Vec2, torch twin, feature extractor): test_tp.py's
    configuration."""
    from transformers import (
        FlaxWav2Vec2Model,
        Wav2Vec2Config,
        Wav2Vec2FeatureExtractor,
        Wav2Vec2Model,
    )

    cfg = Wav2Vec2Config(
        hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=32, conv_dim=(8, 8), conv_kernel=(10, 3),
        conv_stride=(5, 2), num_feat_extract_layers=2,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2,
        do_stable_layer_norm=True, feat_extract_norm="layer",
    )
    fm = FlaxWav2Vec2Model(cfg, seed=0)
    tm = Wav2Vec2Model(cfg)
    tm.load_state_dict(torch_state_dict_from_flax(fm.params))
    return fm, tm.eval(), Wav2Vec2FeatureExtractor()


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    from scipy.io import wavfile

    sr = 16000
    wav = (0.1 * np.random.default_rng(3).normal(size=2 * sr)).astype(
        np.float32)
    path = str(tmp_path_factory.mktemp("tp_audio") / "story.wav")
    wavfile.write(path, sr, wav)
    return path


def test_wav2vec2_param_placement_names(tiny_speech):
    _, tm, _ = tiny_speech
    (copy,) = ttp.shard_lm_params(tm, _lm_mesh(1, 4))
    layer = copy.encoder.layers[0]
    # nn.Linear weights are (out, in): the Flax kernels' shapes transposed.
    assert {tuple(w.shape) for w in layer.attention.q_proj.weights} == {
        (4, 16)}
    assert {tuple(w.shape)
            for w in layer.feed_forward.intermediate_dense.weights} == {
        (8, 16)}
    assert {tuple(w.shape)
            for w in layer.feed_forward.output_dense.weights} == {(16, 8)}


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
def test_speech_tp_forward_matches_unsharded(tiny_speech, wav_file,
                                             mesh_shape):
    from litcoder_core_tpu.features.speech_model import (
        SpeechFeatureExtractor as JaxSpeech,
    )

    fm, tm, fe = tiny_speech
    kw = dict(model_name="tiny-w2v2", chunk_size=0.25, context_size=1.0,
              feature_extractor=fe, batch_size=3)
    ref, ref_t = port_speech.SpeechFeatureExtractor(
        model=tm, device="cpu", **kw).extract_features(wav_file)
    want, want_t = JaxSpeech(model=fm, mesh=jtp.make_lm_mesh(*mesh_shape),
                             **kw).extract_features(wav_file)
    got, got_t = port_speech.SpeechFeatureExtractor(
        model=tm, device="cpu", mesh=_lm_mesh(*mesh_shape),
        **kw).extract_features(wav_file)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_t, ref_t)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def test_speech_mesh_guards(tiny_speech):
    _, tm, fe = tiny_speech
    kw = dict(model_name="x", chunk_size=0.1, context_size=1.0, model=tm,
              feature_extractor=fe, device="cpu")
    with pytest.raises(TypeError, match="make_lm_mesh"):
        port_speech.SpeechFeatureExtractor(mesh=object(), **kw)
    with pytest.raises(ValueError, match="axes"):
        port_speech.SpeechFeatureExtractor(
            mesh=make_mesh(devices=["cpu"] * 2), **kw)


# ---- the command line -------------------------------------------------------

def test_cli_tp_mesh_extraction_matches_single_device(tmp_path,
                                                      gpt2_pair):  # noqa
    """--tp_data 2 --tp_model 4 --device cpu builds the extraction mesh
    through the CLI and leaves the metrics as single-device extraction
    gives them."""
    _, tm = gpt2_pair
    asm_path = str(tmp_path / "asm_tp.pkl")
    save_assembly(_assembly_with_audio(tmp_path), asm_path)
    base = _banded_config(
        tmp_path, asm_path, banded=False, modalities=["language_model"],
        model_names=["tiny-gpt2"], device="cpu",
        extractor_config_overrides={
            "language_model": {"model": tm, "tokenizer": HashStubTokenizer()},
        },
    )
    single = tcli.run(dict(base, cache_dir=str(tmp_path / "c1"),
                           results_dir=str(tmp_path / "r1")))
    config = dict(base, tp_data=2, tp_model=4, cache_dir=str(tmp_path / "c2"),
                  results_dir=str(tmp_path / "r2"))
    meshed = tcli.run(config)
    assert config["_mesh"].shape == {"data": 2, "model": 4}
    assert abs(single["median_score"] - meshed["median_score"]) <= 1e-4
    assert single["n_significant"] == meshed["n_significant"]
    np.testing.assert_array_equal(single["best_alphas"],
                                  meshed["best_alphas"])


def test_cli_tp_flags_parse():
    args = tcli.parse_args([
        "--dataset_type", "lebel", "--modality", "wordrate",
        "--model_name", "wordrate", "--ndelays", "4", "--lookback", "256",
        "--cache_dir", "c", "--tp_data", "2", "--tp_model", "4",
    ])
    assert args.tp_data == 2 and args.tp_model == 4
