"""The port's DeepSeek-V2 module (features/deepseek_v2.py) on the CPU at a
tiny size, against the plain reference (tests/ref_deepseek_v2.py) and
transformers' DeepseekV2Model.

Tiny widths, every mechanism present: hidden 64, 3 layers (1 dense + 2
MoE), 4 MLA heads (no-RoPE 16, RoPE 8, values 16, latent 16), 8 routed
experts of width 32 with top-2 and 1 shared, YaRN as DeepSeek-V2-Lite
publishes it. Weights are seeded random, wider than a checkpoint's
(std 0.2), so attention and routing are far from uniform.

Tolerances, each against the largest magnitude of the compared tensor:
- FP32 2e-5: float32 on both sides; the port sums in other orders (SDPA,
  the experts' combine) and takes RoPE angles in float32 where the
  reference takes float64, a few float32 ulps through 3 layers (1.4e-6
  read);
- BF16 8e-2: the port keeps activations in bf16 (8 significant bits,
  relative rounding 2^-9 per operation, tens of roundings a layer)
  through 3 layers against the reference on the same weights upcast to
  float32 (3.4e-2 read at the last layer; float8's 4 bits would read
  about 16 times that);
- against transformers, FP32 as well (the same arithmetic in float32).

The grouped GEMM and the combine kernel run only on a card: the tests
that take the `card` fixture hold them against the loop of matmuls and
the reference there, and skip here. This file
imports no JAX, so the card's machine runs it:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_deepseek_v2.py
"""

import math

import numpy as np
import pytest
import torch

from litcoder_core_torch.features import deepseek_v2 as dsv2
from litcoder_core_torch.features.language_model import (
    LanguageModelFeatureExtractor,
)
from litcoder_core_torch.utils import profiling
from litcoder_core_torch.utils.testing import HashStubTokenizer
from tests import ref_deepseek_v2 as ref

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

FP32 = 2e-5
BF16 = 8e-2

YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings":
        4096, "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
        "mscale_all_dim": 0.707}
TINY = {
    "vocab_size": 600, "hidden_size": 64, "intermediate_size": 96,
    "moe_intermediate_size": 32, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 4,
    "n_routed_experts": 8, "n_shared_experts": 1, "num_experts_per_tok": 2,
    "kv_lora_rank": 16, "q_lora_rank": None, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "first_k_dense_replace": 1,
    "moe_layer_freq": 1, "norm_topk_prob": False,
    "routed_scaling_factor": 1.0, "topk_method": "greedy", "n_group": 1,
    "topk_group": 1, "scoring_func": "softmax", "hidden_act": "silu",
    "rms_norm_eps": 1e-6, "rope_theta": 10000, "rope_scaling": YARN,
    "attention_bias": False, "max_position_embeddings": 163840,
}


def _weights(cfg, seed=0, std=0.2):
    """Seeded N(0, std^2) for every parameter, RMSNorm gains 1 + N(0,
    (std / 2)^2), under Hugging Face's names."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in
                  dsv2.DeepseekV2Model(cfg).state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=gen)
        if name.endswith("norm.weight"):
            out[name] = 1.0 + (std / 2) * t
        else:
            out[name] = std * t
    return out


def _port(cfg, weights, dtype=torch.float32):
    with torch.device("meta"):
        model = dsv2.DeepseekV2Model(cfg)
    model.load_state_dict({k: v.to(dtype) for k, v in weights.items()},
                          assign=True)
    return model.eval().requires_grad_(False)


def _gap(got, want):
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


@pytest.fixture(scope="module")
def tiny():
    return TINY, _weights(TINY)


@pytest.fixture(scope="module")
def sequences():
    rng = np.random.default_rng(5)
    return [rng.integers(3, 600, n).tolist() for n in (13, 9, 1, 13)]


def _batch(seqs):
    L = max(len(s) for s in seqs)
    ids = torch.zeros((len(seqs), L), dtype=torch.int64)
    mask = torch.zeros_like(ids)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = torch.as_tensor(s)
        mask[i, :len(s)] = 1
    return ids, mask


@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32),
                                       (torch.bfloat16, BF16)],
                         ids=["fp32", "bf16"])
def test_every_hidden_state_matches_the_reference(tiny, sequences, dtype,
                                                  tol):
    cfg, w = tiny
    model = _port(cfg, w, dtype)
    ids, mask = _batch(sequences)        # right-padded
    with torch.inference_mode():
        out = model(input_ids=ids, attention_mask=mask,
                    output_hidden_states=True)
    assert len(out.hidden_states) == cfg["num_hidden_layers"] + 1
    assert out.hidden_states[0].dtype == dtype
    same = {k: v.to(dtype).float() for k, v in w.items()}
    for b, seq in enumerate(sequences):
        want = ref.hidden_states(same, cfg, seq)
        for layer, (got, exp) in enumerate(zip(out.hidden_states, want)):
            assert _gap(got[b, :len(seq)], exp) < tol, (b, layer)
    assert torch.equal(out.last_hidden_state, out.hidden_states[-1])


def test_the_softmax_scale_is_the_published_one():
    cfg = dsv2.DeepseekV2Settings(TINY)
    m = 0.1 * 0.707 * math.log(40) + 1.0
    assert dsv2.softmax_scale(cfg) == pytest.approx(24 ** -0.5 * m * m)
    assert m * m == pytest.approx(1.5896, abs=1e-4)
    assert dsv2.softmax_scale(dsv2.DeepseekV2Settings(
        dict(TINY, rope_scaling=None))) == pytest.approx(24 ** -0.5)


def _fullcontext(words, lookback):
    return [" ".join(words[max(0, i - lookback):i + 1])
            for i in range(len(words))]


@pytest.mark.parametrize("batch_size", [3, 64])
def test_extractor_with_prefix_sharing_matches_the_reference(
        tiny, batch_size):
    cfg, w = tiny
    words = [f"w{k}" for k in np.random.default_rng(2).integers(0, 50, 19)]
    stimuli = _fullcontext(words, lookback=6)
    ex = LanguageModelFeatureExtractor({
        "model_name": "tiny-deepseek-v2", "model": _port(cfg, w),
        "tokenizer": HashStubTokenizer(), "device": "cpu",
        "batch_size": batch_size, "last_token": True})
    assert ex._prefix_sharing_enabled()
    got = ex.extract_all_layers(stimuli)
    assert ex.counts["chain_forwards"] >= 1
    tok = HashStubTokenizer()
    for i, text in enumerate(stimuli):
        want = ref.hidden_states(w, cfg, [tok.bos_token_id]
                                 + tok.encode(text))
        for layer in range(cfg["num_hidden_layers"]):
            assert _gap(torch.from_numpy(got[layer][i]),
                        want[layer][-1]) < FP32, (i, layer)


def _hf_model(cfg, weights):
    """transformers' DeepseekV2Model holding `weights`. transformers 5
    stacks each layer's experts into one tensor per projection, where
    DeepSeek's checkpoints and transformers 4 name each expert's weights:
    there is nothing to compare by name, so the test skips."""
    import transformers
    from transformers import DeepseekV2Config, DeepseekV2Model

    hf_cfg = DeepseekV2Config(**{k: v for k, v in cfg.items()
                                 if k != "scoring_func"},
                              attn_implementation="eager")
    model = DeepseekV2Model(hf_cfg).eval()
    if set(model.state_dict()) != set(weights):
        pytest.skip(f"transformers {transformers.__version__} names "
                    "DeepseekV2's expert weights otherwise")
    model.load_state_dict(weights, strict=True)
    return model


@pytest.mark.parametrize("rope_scaling", [None, YARN], ids=["plain", "yarn"])
def test_matches_transformers(rope_scaling, sequences):
    """Without YaRN the port is transformers' DeepseekV2Model. With YaRN
    it is the same once transformers' softmax scale takes DeepSeek's
    mscale^2: the one departure of transformers' code from the published
    scale, pinned here."""
    cfg = dict(TINY, rope_scaling=rope_scaling and dict(rope_scaling))
    w = _weights(cfg, seed=3)
    hf = _hf_model(cfg, w)
    if rope_scaling is not None:
        m = dsv2.yarn_get_mscale(40, 0.707)
        for layer in hf.layers:
            layer.self_attn.scaling *= m * m
    port = _port(cfg, w)
    ids = torch.as_tensor([sequences[0], sequences[3]])
    with torch.inference_mode():
        want = hf(input_ids=ids, output_hidden_states=True).hidden_states
        got = port(input_ids=ids, output_hidden_states=True).hidden_states
    assert len(got) == len(want)
    for g, h in zip(got, want):
        assert _gap(g, h) < FP32


def test_load_model_builds_the_port_module_from_a_checkpoint(
        tmp_path, monkeypatch):
    import transformers

    w = _weights(TINY, seed=4)
    _hf_model(TINY, w).save_pretrained(tmp_path)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda name: HashStubTokenizer()))
    ex = LanguageModelFeatureExtractor({"model_name": str(tmp_path),
                                        "device": "cpu"})
    assert isinstance(ex._model, dsv2.DeepseekV2Model)
    assert ex._model.config.model_type == "deepseek_v2"
    state = ex._model.state_dict()
    assert set(state) == set(w)
    for name, value in w.items():
        assert torch.equal(state[name], value), name
    assert ex.d_model == 64 and ex.n_layers == 3


def test_experts_load_stacked_and_save_per_expert(tiny):
    """A per-expert state dict loads into one (E, 2 width, hidden) and one
    (E, hidden, width) tensor a layer; the state dict names the experts'
    tensors as the checkpoint did, as views of the stacks."""
    cfg, w = tiny
    state = dict(w)
    model = dsv2.DeepseekV2Model.from_state_dict(cfg, state)
    experts = model.layers[1].mlp.experts
    gu, down = experts.gate_up_proj, experts.down_proj
    assert gu.shape == (8, 64, 64) and down.shape == (8, 64, 32)
    assert not any(".experts.0." in k for k in state)   # stacked in place
    saved = model.state_dict()
    assert set(saved) == set(w)
    for e in range(8):
        p = f"layers.1.mlp.experts.{e}."
        assert torch.equal(gu[e, :32], w[p + "gate_proj.weight"])
        assert torch.equal(gu[e, 32:], w[p + "up_proj.weight"])
        assert torch.equal(down[e], w[p + "down_proj.weight"])
        assert saved[p + "up_proj.weight"].data_ptr() == gu[e, 32:].data_ptr()
        assert saved[p + "down_proj.weight"].data_ptr() == down[e].data_ptr()


def test_expert_gemm_dispatch(monkeypatch):
    """The loop on the CPU; on a CUDA device torch._grouped_mm in bfloat16
    or a refusal, never the loop (it would wait for the device at every
    expert)."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        assert dsv2.expert_gemm(cpu, dtype) is dsv2._looped_gemm
    monkeypatch.setattr(torch, "_grouped_mm", lambda *a, **k: None,
                        raising=False)
    assert dsv2.expert_gemm(cuda, torch.bfloat16) is dsv2._grouped_gemm
    with pytest.raises(ValueError, match="dtype='bfloat16'"):
        dsv2.expert_gemm(cuda, torch.float32)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        dsv2.expert_gemm(torch.device("meta"), torch.bfloat16)
    monkeypatch.delattr(torch, "_grouped_mm")
    with pytest.raises(ValueError, match="_grouped_mm"):
        dsv2.expert_gemm(cuda, torch.bfloat16)


def test_the_moe_takes_its_gemm_from_the_dispatch(tiny, monkeypatch):
    """Every MoE forward asks expert_gemm with its input's device and
    dtype, so the refusals above hold for the whole model."""
    cfg, w = tiny
    asked = []

    def spy(device, dtype):
        asked.append((device.type, dtype))
        return dsv2._looped_gemm

    monkeypatch.setattr(dsv2, "expert_gemm", spy)
    model = _port(cfg, w, torch.bfloat16)
    with torch.inference_mode():
        model(input_ids=torch.tensor([[5, 6, 7]]))
    assert asked == [("cpu", torch.bfloat16)] * 2


def test_looped_gemm_multiplies_each_group_by_its_matrix():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((10, 6), generator=gen)
    w = torch.randn((4, 5, 6), generator=gen)
    ends = torch.tensor([3, 3, 7, 10], dtype=torch.int32)  # one empty
    got = dsv2._looped_gemm(x, w, ends)
    starts = [0, 3, 3, 7]
    for g in range(4):
        lo, hi = starts[g], int(ends[g])
        assert torch.allclose(got[lo:hi], x[lo:hi] @ w[g].T)


def test_spans_and_counts_only_under_a_profiler(tiny, sequences):
    cfg, w = tiny
    model = _port(cfg, w)
    ids, mask = _batch(sequences)
    profiling.clear_spans()
    with torch.inference_mode():
        model(input_ids=ids, attention_mask=mask)
    assert profiling.spans() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.inference_mode():
            model(input_ids=ids, attention_mask=mask)
    spans = profiling.spans()
    profiling.clear_spans()
    names = [s["name"] for s in spans]
    assert names.count("litcoder.lm.mla") == 3
    assert names.count("litcoder.lm.moe") == 2
    assert names.count("litcoder.lm.moe.experts") == 2
    moe = [i for i, s in enumerate(spans) if s["name"] == "litcoder.lm.moe"]
    for i in moe:
        counts = spans[i]["counts"]
        assert counts["tokens"] == ids.numel()
        assert counts["real_tokens"] == int(mask.sum())
        assert isinstance(counts["max_expert_tokens"], int)
        assert counts["max_expert_tokens"] >= counts["tokens"] * 2 / 8
    for s in spans:
        if s["name"] == "litcoder.lm.moe.experts":
            assert s["parent"] in moe


def test_combine_span_and_counts_only_under_a_profiler(tiny, sequences):
    """litcoder.lm.moe.combine: one inside each litcoder.lm.moe, with rows
    (N k), tokens (N) and fused 0 on the CPU (the plain version ran); no
    span without a profiler."""
    cfg, w = tiny
    model = _port(cfg, w, torch.bfloat16)
    ids, mask = _batch(sequences)
    profiling.clear_spans()
    with torch.inference_mode():
        model(input_ids=ids, attention_mask=mask)
    assert profiling.spans() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.inference_mode():
            model(input_ids=ids, attention_mask=mask)
    spans = profiling.spans()
    profiling.clear_spans()
    moe = [i for i, s in enumerate(spans) if s["name"] == "litcoder.lm.moe"]
    combine = [s for s in spans if s["name"] == "litcoder.lm.moe.combine"]
    assert len(moe) == len(combine) == 2
    assert sorted(s["parent"] for s in combine) == moe
    for s in combine:
        assert s["counts"] == {"rows": ids.numel() * 2,
                               "tokens": ids.numel(), "fused": 0}


def test_config_from_transformers_and_refusals():
    from transformers import DeepseekV2Config

    hf = DeepseekV2Config(**{k: v for k, v in TINY.items()
                             if k != "scoring_func"})
    cfg = dsv2.DeepseekV2Settings(hf)
    assert (cfg.hidden_size, cfg.n_routed_experts, cfg.qk_head_dim) == (
        64, 8, 24)
    with pytest.raises(ValueError, match="lacks"):
        dsv2.DeepseekV2Settings({"hidden_size": 8})
    for key, value in (("topk_method", "group_limited_greedy"),
                       ("norm_topk_prob", True), ("q_lora_rank", 8)):
        with pytest.raises(ValueError, match=key):
            dsv2.DeepseekV2Settings(dict(TINY, **{key: value}))


def test_grouped_gemms_match_the_loop_on_the_card(card, tiny):
    """One MoE layer at DeepSeek-V2-Lite's widths (hidden 2,048, 64
    experts of 1,408, top-6, 2 shared) in bf16: the routed experts through
    torch._grouped_mm against the loop of matmuls, on the same rows and
    routes. Both multiply the same bf16 operands with float32
    accumulation and combine in float32; only the order of the float32
    sums differs (1e-5 of the largest output)."""
    cfg = dsv2.DeepseekV2Settings(dict(
        TINY, hidden_size=2048, moe_intermediate_size=1408,
        n_routed_experts=64, num_experts_per_tok=6, n_shared_experts=2))
    with torch.device(card):
        moe = dsv2.DeepseekV2MoE(cfg).to(torch.bfloat16)
    gen = torch.Generator(device=card).manual_seed(1)
    for p in moe.parameters():
        p.data.normal_(0.0, 0.02, generator=gen)
    x = torch.randn((4096, 2048), device=card, dtype=torch.bfloat16,
                    generator=gen)
    with torch.inference_mode():
        weights, ids = moe.route(x)
        gemm = dsv2.expert_gemm(card, torch.bfloat16)
        grouped, ends_g = moe.routed(x, weights, ids, gemm)
        loop, ends_l = moe.routed(x, weights, ids, dsv2._looped_gemm)
    assert torch.equal(ends_g, ends_l) and int(ends_g[-1]) == 4096 * 6
    assert _gap(grouped, loop) < 1e-5


def test_bf16_forward_on_the_card_never_waits(card, tiny, sequences):
    """The bf16 forward on the card (the grouped path) matches the
    reference within BF16 and makes no synchronising call."""
    cfg, w = tiny
    model = _port(cfg, {k: v.to(card) for k, v in w.items()},
                  torch.bfloat16)
    ids, mask = _batch(sequences)
    ids, mask = ids.to(card), mask.to(card)
    with torch.inference_mode():
        model(input_ids=ids, attention_mask=mask)       # stacks, builds
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = model(input_ids=ids, attention_mask=mask,
                        output_hidden_states=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    same = {k: v.bfloat16().float() for k, v in w.items()}
    for b, seq in enumerate(sequences):
        want = ref.hidden_states(same, cfg, seq)
        for got, exp in zip(out.hidden_states, want):
            assert _gap(got[b, :len(seq)].cpu(), exp) < BF16


def test_combine_kernel_runs_once_per_moe_layer_on_the_card(card, tiny,
                                                            sequences):
    """A bf16 forward on the card launches the combine kernel once per MoE
    layer (2 here), waits for the device nowhere (sync debug mode
    'error'), and its combine spans read fused 1."""
    from litcoder_core_torch.ops import moe_combine as mc

    cfg, w = tiny
    model = _port(cfg, {k: v.to(card) for k, v in w.items()},
                  torch.bfloat16)
    ids, mask = _batch(sequences)
    ids, mask = ids.to(card), mask.to(card)
    with torch.inference_mode():
        model(input_ids=ids, attention_mask=mask)       # builds
        torch.cuda.synchronize()
        before = mc.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            model(input_ids=ids, attention_mask=mask)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert mc.launches == before + 2
        profiling.clear_spans()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            model(input_ids=ids, attention_mask=mask)
    spans = profiling.spans()
    profiling.clear_spans()
    fused = [s["counts"]["fused"] for s in spans
             if s["name"] == "litcoder.lm.moe.combine"]
    assert fused == [1, 1]
