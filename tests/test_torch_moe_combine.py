"""The mixture of experts' weighted combine (ops/moe_combine.py): the plain
version on the CPU against the scatter-add it replaced, the inverse
permutation, the wrapper's refusals, and on a card the kernel in
csrc/moe_combine.cu against the plain version.

The tests that take the `card` fixture skip here. This file imports no
JAX, so the card's machine runs it:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_moe_combine.py
"""

import sys
from pathlib import Path

import pytest
import torch

from litcoder_core_torch.ops import moe_combine as mc

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _routed(n, k, h, experts, dtype, device="cpu", seed=0):
    """ys (n k, h) in expert-sorted order as DeepseekV2MoE.routed makes it,
    the sort's order, and softmax weights (n, k) float32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.rand((n, experts), generator=gen, device=device).argsort(
        dim=1)[:, :k]
    order = torch.argsort(ids.reshape(-1), stable=True)
    ys = torch.randn((n * k, h), generator=gen, device=device).to(dtype)
    weights = torch.randn((n, k), generator=gen, device=device).softmax(-1)
    return ys, order, weights


def _scatter_add_combine(ys, order, weights):
    """The combine as DeepseekV2MoE.routed did it before the kernel: a
    float32 index_add of the weighted sorted rows, then a cast."""
    k = weights.shape[1]
    out = torch.zeros((weights.shape[0], ys.shape[1]), dtype=torch.float32,
                      device=ys.device)
    w = weights.reshape(-1)[order]
    out.index_add_(0, order // k, ys.float() * w[:, None])
    return out.to(ys.dtype)


def test_inverse_order_is_the_inverse_permutation():
    _, order, _ = _routed(37, 6, 8, 64, torch.float32)
    pos = mc.inverse_order(order)
    ramp = torch.arange(order.numel())
    assert pos.dtype == torch.int32
    assert torch.equal(pos[order].long(), ramp)
    assert torch.equal(order[pos.long()], ramp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_reference_matches_the_scatter_add(dtype):
    """Both sum the same float32 products, in other orders (the scatter-add
    in expert order, the reference in slot order). Each of the k - 1 adds
    rounds by at most half a float32 ulp of a partial sum, and no partial
    sum exceeds the sum of the products' magnitudes S, so the float32 sums
    differ by at most 2 k 2^-24 S; bf16 entries, rounded from those sums,
    by that and one bf16 ulp of the entry besides."""
    n, k, h = 53, 6, 64
    ys, order, weights = _routed(n, k, h, 16, dtype)
    pos = mc.inverse_order(order)
    got = mc.moe_combine(ys, pos, weights)
    want = _scatter_add_combine(ys, order, weights)
    assert got.dtype == dtype and got.shape == (n, h)
    products = ys[pos.long()].float().view(n, k, h) * weights[..., None]
    tol = 2 * k * 2.0 ** -24 * products.abs().sum(1)
    if dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(want)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


def test_reference_sums_in_slot_order_the_same_bits_every_run():
    ys, order, weights = _routed(29, 6, 16, 8, torch.bfloat16)
    pos = mc.inverse_order(order)
    first = mc.moe_combine(ys, pos, weights)
    assert torch.equal(first, mc.moe_combine(ys, pos, weights))
    rows = ys[pos.long()].float().view(29, 6, 16)
    acc = torch.zeros((29, 16))
    for j in range(6):
        acc = acc + rows[:, j] * weights[:, j, None]
    assert torch.equal(first, acc.to(torch.bfloat16))


class _OnCard:
    """A CPU tensor that says it lies on a CUDA device: enough for the
    wrapper's checks, which run before any launch."""

    device = torch.device("cuda")

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    ys, order, weights = _routed(8, 2, 16, 4, torch.bfloat16)
    pos = mc.inverse_order(order)

    def call(ys=ys, pos=pos, weights=weights):
        return mc.moe_combine(_OnCard(ys), _OnCard(pos), _OnCard(weights))

    with pytest.raises(ValueError, match="multiple of 8"):
        call(ys=torch.zeros((16, 12), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16 rows"):
        call(ys=ys.float())
    with pytest.raises(ValueError, match="strided"):
        call(ys=torch.zeros((16, 32), dtype=torch.bfloat16)[:, ::2])
    with pytest.raises(ValueError, match="strided"):
        call(weights=weights.T.contiguous().T)
    with pytest.raises(ValueError, match="int32"):
        call(pos=pos.long())
    with pytest.raises(ValueError, match="N k = 16"):
        call(weights=weights[:7])
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        mc.moe_combine(ys.to("meta"), pos.to("meta"), weights.to("meta"))


def _bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    m = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


@pytest.mark.parametrize("n,k,h", [(18432, 6, 2048), (1237, 6, 2048),
                                   (301, 6, 5120), (97, 2, 64),
                                   (45, 11, 1032)],
                         ids=["lite", "ragged", "v2", "tiny", "k11"])
def test_kernel_matches_the_reference_on_the_card(card, n, k, h):
    """DeepSeek-V2-Lite's training-cell shape (18,432 tokens, top-6, hidden
    2,048), a ragged N, DeepSeek-V2's hidden 5,120 (a row in three passes
    of a block), the tests' tiny width, and k above the kernel's group of 8
    loads. The kernel and the plain version multiply the same bf16 rows by
    the same float32 weights and add the products in the same slot order,
    each operation rounded (no fused multiply-add), then round to bf16 to
    nearest even: they agree bit for bit. Had the order of the adds
    differed, the float32 sums would differ by a few float32 ulps and the
    bf16 entries by at most one bf16 ulp; that bar is checked first, so a
    failure shows which of the two broke. The check is
    chip_smoke.check_combine_kernel, which phase 3 runs at the first two
    shapes: one launch, a bf16 (n, h) result, the two bars, and a second
    call the same bits."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    ys, order, weights = _routed(n, k, h, 64, torch.bfloat16, card, seed=n)
    assert chip_smoke.check_combine_kernel(ys, mc.inverse_order(order),
                                           weights) <= 1
