"""Port parity for the language-model extractor: the port's
LanguageModelFeatureExtractor on a torch GPT2Model (CPU) against the JAX
extractor on its native Flax path, on the same weights carried across by
litcoder_core_torch.features.convert.torch_state_dict_from_flax. Both run
a tiny GPT-2 (3 layers, width 16, as tests/test_cross_backend_parity.py)
over fullcontext windows with empty strings; features agree within 1e-4
(that test's bar) on every layer."""

import numpy as np
import pytest
import torch

from litcoder_core_torch.features import language_model as port_lm
from litcoder_core_torch.features.convert import torch_state_dict_from_flax
from litcoder_core_torch.utils.testing import HashStubTokenizer

torch.set_num_threads(2)

ATOL = 1e-4
LOOKBACK = 6


def _fullcontext(words, lookback=LOOKBACK):
    """base_processor._process_fullcontext over a tokenizer that maps each
    word to one token: the last `lookback` words up to and including word i,
    and "" where the word is empty."""
    stimuli = []
    for i, w in enumerate(words):
        if w == "":
            stimuli.append("")
            continue
        window = [x for x in words[max(0, i - lookback):i + 1] if x != ""]
        stimuli.append(" ".join(window[-lookback:]))
    return stimuli


@pytest.fixture(scope="module")
def stimuli():
    rng = np.random.default_rng(31)
    words = [f"w{int(k)}" for k in rng.integers(0, 40, 22)]
    words[3] = words[15] = ""
    return _fullcontext(words) + ["zebra qux", "", "lonely"]


@pytest.fixture(scope="module")
def gpt2_pair():
    """(Flax model, torch model) with identical weights."""
    from transformers import FlaxGPT2Model, GPT2Config, GPT2Model

    cfg = GPT2Config(vocab_size=600, n_positions=128, n_embd=16, n_layer=3,
                     n_head=2)
    fm = FlaxGPT2Model(cfg, seed=0)
    tm = GPT2Model(cfg)
    tm.load_state_dict(torch_state_dict_from_flax(fm.params))
    return fm, tm


def _jax_extractor(fm, **cfg):
    from litcoder_core_tpu.features.language_model import (
        LanguageModelFeatureExtractor,
    )

    return LanguageModelFeatureExtractor({
        "model_name": "tiny", "model": fm, "tokenizer": HashStubTokenizer(),
        "backend": "flax", **cfg})


def _port_extractor(tm, **cfg):
    return port_lm.LanguageModelFeatureExtractor({
        "model_name": "tiny", "model": tm, "tokenizer": HashStubTokenizer(),
        "device": "cpu", **cfg})


@pytest.fixture(scope="module")
def jax_all_layers(gpt2_pair, stimuli):
    """JAX features per (last_token, prefix_sharing, batch_size)."""
    cache = {}

    def get(last_token, prefix_sharing, batch_size):
        key = (last_token, prefix_sharing, batch_size)
        if key not in cache:
            cache[key] = _jax_extractor(
                gpt2_pair[0], last_token=last_token,
                prefix_sharing=prefix_sharing,
                batch_size=batch_size).extract_all_layers(stimuli)
        return cache[key]

    return get


@pytest.mark.parametrize("batch_size", [1, 4])
@pytest.mark.parametrize("prefix_sharing", [True, False])
@pytest.mark.parametrize("last_token", [True, False])
def test_all_layers_match_jax(gpt2_pair, stimuli, jax_all_layers,
                              last_token, prefix_sharing, batch_size):
    want = jax_all_layers(last_token, prefix_sharing, batch_size)
    ex = _port_extractor(gpt2_pair[1], last_token=last_token,
                         prefix_sharing=prefix_sharing,
                         batch_size=batch_size)
    got = ex.extract_all_layers(stimuli)
    assert set(got) == set(want) == {0, 1, 2}
    for layer in want:
        assert got[layer].dtype == np.float32
        assert got[layer].shape == (len(stimuli), 16)
        np.testing.assert_allclose(got[layer], want[layer], atol=ATOL,
                                   err_msg=f"layer {layer}")
    empty = [i for i, s in enumerate(stimuli) if s == ""]
    assert empty and not any(got[layer][empty].any() for layer in got)
    assert set(ex.last_stage_seconds) == {"tokenize_s", "fetch_wait_s",
                                          "forward_total_s", "host_prep_s"}
    chained = ex.counts["chain_forwards"] > 0
    assert chained == prefix_sharing
    assert ex.counts["windows"] == len(stimuli) - len(empty)


@pytest.mark.parametrize("hook_type", ["hook_resid_pre", "hook_resid_post"])
def test_single_layer_matches_jax(gpt2_pair, stimuli, hook_type):
    common = dict(last_token=True, layer_idx=1, hook_type=hook_type,
                  batch_size=4)
    want = _jax_extractor(gpt2_pair[0], **common).extract_features(stimuli)
    ex = _port_extractor(gpt2_pair[1], **common)
    np.testing.assert_allclose(ex.extract_features(stimuli), want, atol=ATOL)
    # -1 is the last block; the offset of hook_resid_post holds for it too.
    np.testing.assert_allclose(
        ex.extract_features(stimuli, layer_idx=-1),
        ex.extract_all_layers(stimuli)[2], atol=1e-6)


def test_state_dict_equals_transformers_loader(gpt2_pair):
    from transformers import GPT2Model
    from transformers.modeling_flax_pytorch_utils import (
        load_flax_weights_in_pytorch_model,
    )

    fm, tm = gpt2_pair
    want = load_flax_weights_in_pytorch_model(GPT2Model(fm.config),
                                              fm.params).state_dict()
    got = torch_state_dict_from_flax(fm.params)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key
    # The flattened form gives the same dict.
    from flax.traverse_util import flatten_dict

    for flat in (flatten_dict(fm.params), flatten_dict(fm.params, sep=".")):
        again = torch_state_dict_from_flax(flat)
        assert set(again) == set(got)
        assert all(torch.equal(again[k], got[k]) for k in got)


def test_prefix_chains_and_buckets_match_jax():
    from litcoder_core_tpu.features import language_model as jax_lm

    rng = np.random.default_rng(5)
    for trial in range(20):
        base = [int(t) for t in rng.integers(0, 9, 12)]
        lists = []
        for _ in range(int(rng.integers(1, 30))):
            if rng.uniform() < 0.6 and lists:
                prev = lists[-1]
                lists.append(prev + [int(t) for t in
                                     rng.integers(0, 9, rng.integers(0, 3))])
            else:
                lists.append(base[:int(rng.integers(1, 12))])
        min_chain = int(rng.integers(1, 6))
        assert (port_lm._find_prefix_chains(lists, min_chain)
                == jax_lm._find_prefix_chains(lists, min_chain)), trial
    for n in list(range(0, 300, 7)) + [256, 257, 288, 289]:
        for gran, minimum in ((32, 32), (8, 8), (16, 1)):
            assert (port_lm._pad_to_bucket(n, gran, minimum)
                    == jax_lm._pad_to_bucket(n, gran, minimum))


@pytest.mark.parametrize("last_token,prefix_sharing",
                         [(True, False), (False, False), (False, True)])
def test_bf16_close_to_fp32(gpt2_pair, stimuli, last_token, prefix_sharing):
    """dtype='bfloat16' runs on a bf16 copy of the weights and stays within
    the JAX bf16 test's bound of the fp32 features."""
    common = dict(last_token=last_token, prefix_sharing=prefix_sharing,
                  batch_size=4)
    tm = gpt2_pair[1]
    f32 = _port_extractor(tm, **common).extract_all_layers(stimuli)
    ex = _port_extractor(tm, dtype="bfloat16", **common)
    bf16 = ex.extract_all_layers(stimuli)
    assert ex._compute_model is not ex._model
    assert next(ex._compute_model.parameters()).dtype == torch.bfloat16
    assert next(tm.parameters()).dtype == torch.float32
    for layer in f32:
        assert bf16[layer].dtype == np.float32
        rel = (np.linalg.norm(f32[layer] - bf16[layer])
               / max(np.linalg.norm(f32[layer]), 1e-6))
        assert rel < 0.05, (layer, rel)


def test_errors_match_jax(gpt2_pair):
    from litcoder_core_tpu.features.language_model import (
        LanguageModelFeatureExtractor as JaxLM,
    )

    tm = gpt2_pair[1]
    base = {"model": tm, "tokenizer": HashStubTokenizer(), "device": "cpu"}
    for bad, match in (({}, "model_name"),
                       ({"model_name": "x", "context_type": "bogus"},
                        "context_type"),
                       ({"model_name": "x", "dtype": "float16"}, "dtype"),
                       ({"model_name": "x", "layer_idx": "9"}, "integer")):
        for cls in (JaxLM, port_lm.LanguageModelFeatureExtractor):
            with pytest.raises(ValueError, match=match):
                cls({**base, **bad})
    ex = _port_extractor(tm)
    with pytest.raises(ValueError, match="out of range"):
        ex.extract_features(["a b"], layer_idx=3)
    with pytest.raises(ValueError, match="out of range"):
        ex.extract_features(["a b"], layer_idx=-4)
    with pytest.raises(ValueError, match="torch models"):
        _port_extractor(tm, backend="flax")
    # The mesh is ported (tests/test_torch_tp.py); these are its guards.
    from litcoder_core_torch.parallel.mesh import make_mesh
    from litcoder_core_torch.parallel.tp import make_lm_mesh

    with pytest.raises(TypeError, match="Mesh"):
        _port_extractor(tm, mesh=object())
    with pytest.raises(ValueError, match="axes"):
        _port_extractor(tm, mesh=make_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="mesh's devices"):
        _port_extractor(tm, mesh=make_lm_mesh(1, 2,
                                              devices=["cuda:0"] * 2))


def test_encode_and_injection(gpt2_pair):
    class SpecialsAdding(HashStubTokenizer):
        def encode(self, text, add_special_tokens=True):
            ids = super().encode(text)
            return [1] + ids + [2] if add_special_tokens else ids

    tm = gpt2_pair[1]
    ex = port_lm.LanguageModelFeatureExtractor({
        "model_name": "tiny", "model": tm, "tokenizer": SpecialsAdding(),
        "device": "cpu", "backend": "auto"})
    ids = ex._encode("hello world")
    assert ids[0] == 1 and ids.count(1) == 1 and 2 not in ids
    assert ex.backend == "torch" and not ex._model.training
    assert (ex.d_model, ex.n_layers) == (16, 3)
    assert ex._prefix_sharing_enabled()  # GPT-2 is causal
    assert not _port_extractor(tm, prefix_sharing=False
                               )._prefix_sharing_enabled()


def test_pipelined_fetch_keeps_depth_and_order():
    seen = []
    pipe = port_lm._PipelinedFetch(2, lambda arr, meta: seen.append(
        (meta, float(arr[0]))))
    for k in range(5):
        pipe.push(torch.full((1,), float(k)), k)
        assert len(seen) == max(0, k - 1)
    pipe.flush()
    assert seen == [(k, float(k)) for k in range(5)]


def test_bf16_model_runs_as_it_is_and_fp32_gets_a_copy(gpt2_pair):
    """dtype='bfloat16' with a model whose floating weights are all bf16
    uses that model, no copy (its parameters share storage); an fp32 model
    still gets a bf16 copy and is left in fp32."""
    import copy

    tm = gpt2_pair[1]
    bf = copy.deepcopy(tm).to(torch.bfloat16)
    ex = _port_extractor(bf, dtype="bfloat16")
    assert ex._compute_model is bf
    for p, q in zip(ex._compute_model.parameters(), bf.parameters()):
        assert p.data_ptr() == q.data_ptr()
    ex32 = _port_extractor(tm, dtype="bfloat16")
    assert ex32._compute_model is not tm
    got = dict(ex32._compute_model.named_parameters())
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32
        assert got[name].dtype == torch.bfloat16
        assert got[name].data_ptr() != p.data_ptr()


def test_a_tp_mesh_refuses_deepseek_v2():
    from litcoder_core_torch.features import deepseek_v2 as dsv2
    from litcoder_core_torch.parallel.tp import make_lm_mesh

    cfg = {"vocab_size": 64, "hidden_size": 16, "intermediate_size": 24,
           "moe_intermediate_size": 8, "num_hidden_layers": 2,
           "num_attention_heads": 2, "n_routed_experts": 4,
           "n_shared_experts": 1, "num_experts_per_tok": 2,
           "kv_lora_rank": 8, "qk_nope_head_dim": 8, "qk_rope_head_dim": 4,
           "v_head_dim": 8, "first_k_dense_replace": 1}
    model = dsv2.DeepseekV2Model(cfg)
    with pytest.raises(ValueError, match="MLA .*MoE.* unsupported"):
        _port_extractor(model, mesh=make_lm_mesh(1, 2, device="cpu"))
