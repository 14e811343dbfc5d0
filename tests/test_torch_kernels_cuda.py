"""The port's Hopper attention kernels against their plain PyTorch
versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs a GPU: it is
marked ``cuda`` and skips with a reason elsewhere. This file imports no
JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Inputs are seeded normal bf16. Both sides round at the same points (P and
dS to bf16, outputs to bf16); they differ in fp32 summation order, which
can move a rounded value by one bf16 step (2⁻⁸ relative). Tolerance:
max |kernel - plain| <= 1e-2 · max |plain| for out, dq, dk, dv, and 1e-3
absolute for the fp32 lse.
"""

import pytest
import torch

from byteps_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

SHAPES = [  # (b, sq, sk, h)
    (2, 128, 128, 4),
    (2, 256, 256, 4),
    (1, 512, 512, 16),
    (2, 128, 256, 4),       # cross-attention, sq != sk
    (2, 512, 192, 2),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, b, sq, sk, h, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda s: torch.randn(b, s, h, 64, generator=g).to(dev, torch.bfloat16)
    return mk(sq), mk(sk), mk(sk), mk(sq)


def _close(got, ref, name, rel=1e-2):
    err = (got.float() - ref.float()).abs().max().item()
    bound = rel * ref.float().abs().max().item()
    assert err <= bound, f"{name}: max err {err:.3e} > {bound:.3e}"


def _cases():
    for b, sq, sk, h in SHAPES:
        for causal in (False, True):
            if causal and sq != sk:
                continue
            yield pytest.param(b, sq, sk, h, causal,
                               id=f"b{b}-q{sq}-k{sk}-h{h}-{'causal' if causal else 'full'}")


@pytest.mark.parametrize("b,sq,sk,h,causal", list(_cases()))
def test_forward_kernel_matches_plain(cuda, b, sq, sk, h, causal):
    q, k, v, _ = _inputs(cuda, b, sq, sk, h)
    n0 = fa.flash_fwd.launches
    out, lse = fa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == n0 + 1
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(out, ref_out, "out")
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("b,sq,sk,h,causal", list(_cases()))
def test_fused_backward_kernel_matches_plain(cuda, b, sq, sk, h, causal):
    q, k, v, do = _inputs(cuda, b, sq, sk, h, seed=1)
    _, lse = fa.flash_fwd_plain(q, k, v, causal)
    n0 = fa.flash_bwd_fused.launches
    got = fa.flash_bwd_fused(q, k, v, do, lse, causal)
    torch.cuda.synchronize()
    assert fa.flash_bwd_fused.launches == n0 + 1
    ref = fa.flash_bwd_fused_plain(q, k, v, do, lse, causal)
    for g_, r_, name in zip(got, ref, ("dq", "dk", "dv")):
        _close(g_, r_, name)


def test_kernels_read_strided_views_in_place(cuda):
    """q, k, v as views of one packed [b, s, 3, h, d] projection (the
    model's layout) give the same bits as contiguous copies."""
    g = torch.Generator(device="cpu").manual_seed(2)
    qkv = torch.randn(2, 256, 3, 4, 64, generator=g).to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(2, 256, 4, 64, generator=g).to(cuda, torch.bfloat16)
    out, lse = fa.flash_fwd(q, k, v)
    out_c, lse_c = fa.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
    grads = fa.flash_bwd_fused(q, k, v, do, lse)
    grads_c = fa.flash_bwd_fused(q.contiguous(), k.contiguous(),
                                 v.contiguous(), do, lse)
    for a, b in zip(grads, grads_c):
        assert torch.equal(a, b)


def test_autograd_function_runs_both_kernels(cuda):
    q, k, v, do = _inputs(cuda, 2, 128, 128, 4, seed=3)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    f0, b0 = fa.flash_fwd.launches, fa.flash_bwd_fused.launches
    out = fa.attention(q, k, v)
    out.backward(do)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == f0 + 1
    assert fa.flash_bwd_fused.launches == b0 + 1
    ref = fa.flash_bwd_fused_plain(q.detach(), k.detach(), v.detach(), do,
                                   fa.flash_fwd_plain(q, k, v)[1])
    for t, r_, name in zip((q, k, v), ref, "qkv"):
        _close(t.grad, r_, "d" + name)


def test_cuda_fp32_input_raises_instead_of_falling_back(cuda):
    q = torch.zeros(1, 64, 1, 64, device=cuda)
    n0 = fa.flash_fwd.launches
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_fwd(q, q, q)
    assert fa.flash_fwd.launches == n0
