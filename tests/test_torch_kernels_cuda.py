"""The port's Hopper kernels (flash attention forward, fused and split
backward, onebit pack and unpack, int8 quantize and dequantize, fp8
stochastic rounding) against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs a GPU: it is
marked ``cuda`` and skips with a reason elsewhere. This file imports no
JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Inputs are seeded normal bf16. Both sides round at the same points (P and
dS to bf16, outputs to bf16); they differ in fp32 summation order, which
can move a rounded value by one bf16 step (2⁻⁸ relative). Tolerance:
max |kernel - plain| <= 1e-2 · max |plain| for out, dq, dk, dv, and 1e-3
absolute for the fp32 lse. The onebit and quantize kernels move bits: they
must agree with their plain versions bit for bit.
"""

import pytest
import torch

from byteps_tpu_torch.ops import flash_attention as fa
from byteps_tpu_torch.ops.compression import kernels as ob

pytestmark = pytest.mark.cuda

SHAPES = [  # (b, sq, sk, h)
    (2, 128, 128, 4),
    (2, 256, 256, 4),
    (1, 512, 512, 16),
    (2, 128, 256, 4),       # cross-attention, sq != sk
    (2, 512, 192, 2),
    (2, 1024, 1024, 2),     # two 512 blocks: the GPT-2 context
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


@pytest.mark.parametrize("b,sq,sk,h,causal", list(_cases()))
def test_split_backward_kernels_match_plain(cuda, b, sq, sk, h, causal):
    """dq and dk/dv with delta = rowsum(dO∘out) from the forward's bf16
    output, as the split route computes it."""
    q, k, v, do = _inputs(cuda, b, sq, sk, h, seed=4)
    out, lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = fa.bwd_delta(do, out)
    n0 = fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == \
        (n0[0] + 1, n0[1] + 1)
    _close(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal), "dq")
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    _close(dk, ref_dk, "dk")
    _close(dv, ref_dv, "dv")


def test_split_kernels_read_strided_views_in_place(cuda):
    g = torch.Generator(device="cpu").manual_seed(5)
    qkv = torch.randn(2, 192, 3, 4, 64, generator=g).to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(2, 192, 4, 64, generator=g).to(cuda, torch.bfloat16)
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.bwd_delta(do, out)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    assert torch.equal(fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
                       fa.flash_bwd_dq(qc, kc, vc, do, lse, delta, True))
    for a, c in zip(fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
                    fa.flash_bwd_dkv(qc, kc, vc, do, lse, delta, True)):
        assert torch.equal(a, c)


def test_autograd_takes_the_split_kernels_past_one_block(cuda):
    """At seq 1024 (two 512 blocks) the autograd Function runs the forward
    kernel, then the dq and dk/dv kernels, and never the fused one."""
    q, k, v, do = _inputs(cuda, 1, 1024, 1024, 2, seed=6)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    names = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
    n0 = [getattr(fa, n).launches for n in names]
    fa.attention(q, k, v, causal=True).backward(do)
    torch.cuda.synchronize()
    assert [getattr(fa, n).launches - c for n, c in zip(names, n0)] == \
        [1, 0, 1, 1]
    qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa.flash_fwd_plain(qa, ka, va, True)[0].backward(do)
    for t, ref, name in zip((q, k, v), (qa, ka, va), "qkv"):
        _close(t.grad, ref.grad, "d" + name, rel=3e-2)   # plain P, dS unrounded


def _onebit_vectors():
    f = torch.finfo(torch.float32)
    head = torch.tensor([0.0, -0.0, float("nan"), -float("nan"), float("inf"),
                         -float("inf"), f.tiny / 4, -f.tiny / 4, f.tiny,
                         -f.tiny, 1.0, -1.0])
    g = torch.Generator(device="cpu").manual_seed(7)
    yield "adversarial_77", torch.cat([head, torch.randn(65, generator=g)])
    for n in (1, 31, 32, 33, 4_096_000 // 4):
        yield f"n{n}", torch.randn(n, generator=g)


def test_onebit_kernels_match_plain_bit_for_bit(cuda):
    for name, x in _onebit_vectors():
        x = x.to(cuda)
        p0, u0 = ob.onebit_pack.launches, ob.onebit_unpack.launches
        words = ob.onebit_pack(x)
        signs = ob.onebit_unpack(words, x.numel())
        torch.cuda.synchronize()
        assert (ob.onebit_pack.launches, ob.onebit_unpack.launches) == \
            (p0 + 1, u0 + 1), name
        assert words.dtype == torch.int32 and words.numel() == ob.words_for(x.numel())
        assert torch.equal(words, ob.onebit_pack_plain(x)), name
        assert torch.equal(signs.view(torch.int32),
                           ob.onebit_unpack_plain(words, x.numel()).view(torch.int32)), name


def test_onebit_cuda_inputs_the_kernels_do_not_take_raise(cuda):
    n0 = ob.onebit_pack.launches
    with pytest.raises(TypeError, match="float32"):
        ob.onebit_pack(torch.zeros(64, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="fit"):
        ob.onebit_unpack(torch.zeros(2, device=cuda, dtype=torch.int32), 65)
    assert ob.onebit_pack.launches == n0


# ------------------------------------- int8 and fp8 quantizers (rows 7-9)
#
# The contract is bytes, byte-identical to the numpy codec: kernel and plain
# version must agree bit for bit on every element (NaN inputs are outside
# it: the card divides to one canonical NaN).

def _quant_vectors():
    from byteps_tpu_torch.compress import device as cdev
    f = torch.finfo(torch.float32)
    yield "probe", torch.from_numpy(cdev.probe_vector())
    yield "edges", torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                                 f.tiny / 4, -f.tiny / 4, f.max, -f.max,
                                 0.5, 1.5, 2.5, -0.5, -2.5, 3.5])
    g = torch.Generator(device="cpu").manual_seed(9)
    for n in (1, 127, 128 * 256 + 3, 1_024_000):
        yield f"n{n}", torch.randn(n, generator=g) * 3


def _scales(x, denom):
    amax = x[torch.isfinite(x)].abs().max().item()
    return [amax / denom, 1.0, 0.0, 1e-30]


def test_int8_kernels_match_plain_bit_for_bit(cuda):
    for name, x in _quant_vectors():
        x = x.to(cuda)
        for s in _scales(x, 127.0):
            q0, d0 = ob.int8_quantize.launches, ob.int8_dequantize.launches
            q = ob.int8_quantize(x, s)
            d = ob.int8_dequantize(q, s)
            torch.cuda.synchronize()
            assert (ob.int8_quantize.launches, ob.int8_dequantize.launches) \
                == (q0 + 1, d0 + 1)
            assert q.dtype == torch.int8 and d.dtype == torch.float32
            assert torch.equal(q, ob.int8_quantize_plain(x, s)), (name, s)
            assert torch.equal(d.view(torch.int32), ob.int8_dequantize_plain(
                q, s).view(torch.int32)), (name, s)


@pytest.mark.parametrize("seed", [0, 0xFFFFFFFF, 1234])
@pytest.mark.parametrize("kind", [0, 1], ids=["e4m3", "e5m2"])
def test_fp8_sr_kernel_matches_plain_bit_for_bit(cuda, kind, seed):
    from byteps_tpu_torch.ops.compression import fp8sr
    for name, x in _quant_vectors():
        x = x.to(cuda)
        for s in _scales(x, fp8sr.fmt_max(kind)):
            n0 = ob.fp8_sr_quantize.launches
            q = ob.fp8_sr_quantize(x, s, seed, kind)
            torch.cuda.synchronize()
            assert ob.fp8_sr_quantize.launches == n0 + 1
            assert q.dtype == torch.uint8
            assert torch.equal(q, ob.fp8_sr_quantize_plain(x, s, seed, kind)), \
                (name, s)


def test_device_encode_on_the_card_is_the_numpy_codec(cuda):
    """The probe passes on the card, and an EF encode of a split bucket
    through the kernels equals the one through the plain versions:
    payload and new residual, bit for bit."""
    import numpy as np

    from byteps_tpu_torch.compress import device as cdev
    from byteps_tpu_torch.compress import wire
    cdev.reset_probe()
    assert cdev._probe(cuda)
    g = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(40_000, generator=g).to(cuda)
    r = (torch.randn(40_000, generator=g) * 1e-2).to(cuda)
    parts = [(x[:12_345], 0, 12_345), (x, 12_345, 40_000 - 12_345)]
    for cid in cdev.DEVICE_CODECS:
        got, got_r, d2h = cdev.encode_bucket(parts, 40_000, cid, 77, r, True)
        ref, ref_r, _ = cdev.encode_bucket(parts, 40_000, cid, 77, r, True,
                                           plain=True)
        assert got == ref and d2h == 40_000 + 4
        assert torch.equal(got_r.view(torch.int32), ref_r.view(torch.int32))
        host = (x + r).cpu().numpy()
        assert got == wire.encode(cid, host, seed=77)
        assert np.array_equal(got_r.cpu().numpy(),
                              host - wire.decode(got, 40_000, np.float32))


def test_quant_cuda_inputs_the_kernels_do_not_take_raise(cuda):
    n0 = ob.int8_quantize.launches
    with pytest.raises(TypeError, match="float32"):
        ob.int8_quantize(torch.zeros(64, device=cuda, dtype=torch.bfloat16), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ob.int8_quantize(torch.zeros(64, device=cuda)[::2], 1.0)
    with pytest.raises(TypeError, match="int8"):
        ob.int8_dequantize(torch.zeros(64, device=cuda), 1.0)
    with pytest.raises(TypeError, match="float32"):
        ob.fp8_sr_quantize(torch.zeros(2, 4, device=cuda), 1.0, 0, 0)
    assert ob.int8_quantize.launches == n0
