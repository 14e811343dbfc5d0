"""The port's Hopper kernels (flash attention forward, fused and split
backward, the forward and split backward with an additive bias or T5's
rel table, onebit pack and unpack, int8 quantize and dequantize, fp8
stochastic rounding) against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs a GPU: it is
marked ``cuda`` and skips with a reason elsewhere. This file imports no
JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

The flash checks run at head dims 64 and 128, the two widths the kernels
are built for; another width raises. Inputs are seeded normal bf16. Both sides round at the same points (P and
dS to bf16, outputs to bf16); they differ in fp32 summation order, which
can move a rounded value by one bf16 step (2⁻⁸ relative). Tolerance:
max |kernel - plain| <= 1e-2 · max |plain| for out, dq, dk, dv, dbias and
dtable (fp32 sums of the same dS in another order), and 1e-3 absolute for
the fp32 lse. The dense and table forms given the same bias values run the
same arithmetic and must agree bit for bit, and dtable must be the same
bits on every launch. The onebit and quantize kernels move bits: they
must agree with their plain versions bit for bit. The ring's two forms:
the forward's fp32 out, rounded to bf16, must be the bf16 launch's out
bit for bit (the two differ only in the store), and the fused backward
with delta given must be the split route's dq and dk/dv with the same
delta bit for bit (the same kernels).
"""

import pytest
import torch

import chip_smoke as smoke
from byteps_tpu_torch.ops import flash_attention as fa
from byteps_tpu_torch.ops.compression import kernels as ob

pytestmark = pytest.mark.cuda

WIDTHS = fa.KERNEL_DS       # the head dims the flash kernels are built for
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


def _inputs(dev, b, sq, sk, h, seed=0, d=64):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda s: torch.randn(b, s, h, d, generator=g).to(dev, torch.bfloat16)
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


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("b,sq,sk,h,causal", list(_cases()))
def test_forward_kernel_matches_plain(cuda, b, sq, sk, h, causal, d):
    q, k, v, _ = _inputs(cuda, b, sq, sk, h, d=d)
    n0, nd = fa.flash_fwd.launches, fa.flash_fwd.launches_d[d]
    out, lse = fa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == n0 + 1
    assert fa.flash_fwd.launches_d[d] == nd + 1
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(out, ref_out, "out")
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("b,sq,sk,h,causal", list(_cases()))
def test_fused_backward_kernel_matches_plain(cuda, b, sq, sk, h, causal, d):
    q, k, v, do = _inputs(cuda, b, sq, sk, h, seed=1, d=d)
    _, lse = fa.flash_fwd_plain(q, k, v, causal)
    n0, nd = fa.flash_bwd_fused.launches, fa.flash_bwd_fused.launches_d[d]
    got = fa.flash_bwd_fused(q, k, v, do, lse, causal)
    torch.cuda.synchronize()
    assert fa.flash_bwd_fused.launches == n0 + 1
    assert fa.flash_bwd_fused.launches_d[d] == nd + 1
    ref = fa.flash_bwd_fused_plain(q, k, v, do, lse, causal)
    for g_, r_, name in zip(got, ref, ("dq", "dk", "dv")):
        _close(g_, r_, name)


@pytest.mark.parametrize("d", WIDTHS)
def test_kernels_read_strided_views_in_place(cuda, d):
    """q, k, v as views of one packed [b, s, 3, h, d] projection (the
    model's layout) give the same bits as contiguous copies."""
    g = torch.Generator(device="cpu").manual_seed(2)
    qkv = torch.randn(2, 256, 3, 4, d, generator=g).to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(2, 256, 4, d, generator=g).to(cuda, torch.bfloat16)
    out, lse = fa.flash_fwd(q, k, v)
    out_c, lse_c = fa.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
    grads = fa.flash_bwd_fused(q, k, v, do, lse)
    grads_c = fa.flash_bwd_fused(q.contiguous(), k.contiguous(),
                                 v.contiguous(), do, lse)
    for a, b in zip(grads, grads_c):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", WIDTHS)
def test_kernels_launch_from_a_thread_with_no_cuda_call_yet(cuda, d):
    """PyTorch runs a backward on its autograd thread, which may reach a
    kernel before any CUDA call there made a context current; the tensor
    maps are encoded there all the same, and the results are the main
    thread's bits."""
    import threading
    q, k, v, do = _inputs(cuda, 2, 128, 128, 4, seed=7, d=d)
    out, lse = fa.flash_fwd(q, k, v)
    grads = fa.flash_bwd_fused(q, k, v, do, lse)
    got = {}

    def run():
        try:
            got["fwd"] = fa.flash_fwd(q, k, v)
            got["bwd"] = fa.flash_bwd_fused(q, k, v, do, lse)
            torch.cuda.synchronize()
        except BaseException as e:      # noqa: BLE001 — re-raised below
            got["error"] = e

    th = threading.Thread(target=run)
    th.start()
    th.join()
    if "error" in got:
        raise got["error"]
    assert torch.equal(got["fwd"][0], out) and torch.equal(got["fwd"][1], lse)
    for a, b in zip(got["bwd"], grads):
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


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("b,sq,sk,h,causal", list(_cases()))
def test_fp32_out_forward_matches_plain_and_the_bf16_launch(cuda, b, sq, sk,
                                                            h, causal, d):
    """Form 1f (the ring's partial output): out in fp32 against the plain
    version, and rounded to bf16 the bf16 launch's out, bit for bit."""
    q, k, v, _ = _inputs(cuda, b, sq, sk, h, seed=9, d=d)
    n0, nf = fa.flash_fwd.launches, fa.flash_fwd.launches_f32_d[d]
    out, lse = fa.flash_fwd(q, k, v, causal, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_fwd.launches_f32_d[d]) == \
        (n0 + 1, nf + 1)
    assert out.dtype == torch.float32 and out.shape == (b, sq, h, d)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal,
                                          out_dtype=torch.float32)
    _close(out, ref_out, "out")
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    out16, lse16 = fa.flash_fwd(q, k, v, causal)
    assert torch.equal(out.to(torch.bfloat16), out16)
    assert torch.equal(lse, lse16)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("b,sq,sk,h,causal", list(_cases()))
def test_fused_backward_with_delta_matches_plain_and_split(cuda, b, sq, sk,
                                                           h, causal, d):
    """Form 2d (the ring's per-block backward): the fused backward with a
    given delta = rowsum(dO∘out) against the plain version, and bit for
    bit against dq then dk/dv with the same delta."""
    q, k, v, do = _inputs(cuda, b, sq, sk, h, seed=10, d=d)
    out, lse = fa.flash_fwd(q, k, v, causal)
    delta = fa.bwd_delta(do, out)
    n0, nd = fa.flash_bwd_fused.launches, fa.flash_bwd_fused.launches_delta_d[d]
    got = fa.flash_bwd_fused(q, k, v, do, lse, causal, delta=delta)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_fused.launches,
            fa.flash_bwd_fused.launches_delta_d[d]) == (n0 + 1, nd + 1)
    ref = fa.flash_bwd_fused_plain(q, k, v, do, lse, causal, delta=delta)
    for g_, r_, name in zip(got, ref, ("dq", "dk", "dv")):
        _close(g_, r_, name)
    split = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal))
    for g_, s_, name in zip(got, split, ("dq", "dk", "dv")):
        assert torch.equal(g_, s_), name


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("causal", [False, True])
def test_ring_schedule_at_sp4_matches_full_attention(cuda, causal, d):
    """The flash ring's schedule of 4 ranks in one process (shards of 128:
    diagonal, visible and hidden blocks) against the plain attention of
    the whole sequence and its autograd (3e-2: its P and dS unrounded)."""
    from byteps_tpu_torch.parallel import ring
    q, k, v, do = _inputs(cuda, 1, 512, 512, 4, seed=11, d=d)
    names = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
    n0 = [getattr(fa, n).launches for n in names]
    out, _, dq, dk, dv = ring.ring_schedule(q, k, v, do, 4, causal)
    torch.cuda.synchronize()
    blocks = 10 if causal else 16
    assert [getattr(fa, n).launches - c for n, c in zip(names, n0)] == \
        [blocks, blocks, 0, 0]
    qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref = fa.flash_fwd_plain(qa, ka, va, causal)[0]
    ref.backward(do)
    _close(out, ref, "out")
    for got, t, name in zip((dq, dk, dv), (qa, ka, va), "qkv"):
        _close(got, t.grad, "d" + name, rel=3e-2)


def test_ring_on_cuda_refuses_what_the_kernels_do_not_take(cuda):
    """The flash ring on CUDA tensors launches the kernels or raises: fp32
    inputs never reach a plain version."""
    from byteps_tpu_torch.parallel import mesh, ring
    q = torch.zeros(1, 128, 2, 64, device=cuda)
    n0 = fa.flash_fwd.launches
    with mesh.use_mesh(mesh.make_mesh({"seq": 1})):
        with pytest.raises(TypeError, match="bfloat16"):
            ring.ring_attention(q, q, q, "seq")
    assert fa.flash_fwd.launches == n0


def test_cuda_fp32_input_raises_instead_of_falling_back(cuda):
    q = torch.zeros(1, 64, 1, 64, device=cuda)
    n0 = fa.flash_fwd.launches
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_fwd(q, q, q)
    assert fa.flash_fwd.launches == n0


def test_cuda_head_dim_96_raises_from_every_wrapper(cuda):
    """A width the kernels are not built for raises from each wrapper,
    never reaching a kernel or a plain version."""
    q, k, v, do = _inputs(cuda, 1, 128, 128, 2, seed=8, d=96)
    lse = torch.zeros(1, 2, 128, device=cuda)
    names = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
    n0 = [getattr(fa, n).launches for n in names]
    calls = (lambda: fa.flash_fwd(q, k, v),
             lambda: fa.flash_bwd_fused(q, k, v, do, lse),
             lambda: fa.flash_bwd_dq(q, k, v, do, lse, lse),
             lambda: fa.flash_bwd_dkv(q, k, v, do, lse, lse),
             lambda: fa.attention(q, k, v))
    for call in calls:
        with pytest.raises(NotImplementedError, match="head_dim 96"):
            call()
    assert [getattr(fa, n).launches for n in names] == n0


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("b,sq,sk,h,causal", list(_cases()))
def test_split_backward_kernels_match_plain(cuda, b, sq, sk, h, causal, d):
    """dq and dk/dv with delta = rowsum(dO∘out) from the forward's bf16
    output, as the split route computes it."""
    q, k, v, do = _inputs(cuda, b, sq, sk, h, seed=4, d=d)
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


@pytest.mark.parametrize("d", WIDTHS)
def test_autograd_takes_the_split_kernels_past_one_block(cuda, d):
    """At seq 1024 (two 512 blocks) the autograd Function runs the forward
    kernel, then the dq and dk/dv kernels, and never the fused one."""
    q, k, v, do = _inputs(cuda, 1, 1024, 1024, 2, seed=6, d=d)
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


# The edges of the kernels' TMA ring (two stages of 64-row tiles): one
# tile (fewer tiles than stages), two, a cross shape whose key walk is
# twice its query walk, and a causal walk of 16 tiles.
EDGES = [  # (id, b, sq, sk, h, causal)
    ("one-tile", 2, 64, 64, 2, False),
    ("one-tile-causal", 2, 64, 64, 2, True),
    ("two-tiles-causal", 2, 128, 128, 2, True),
    ("cross-q512-k1024", 1, 512, 1024, 4, False),
    ("causal-1024", 1, 1024, 1024, 4, True),
]


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("b,sq,sk,h,causal",
                         [pytest.param(*e[1:], id=e[0]) for e in EDGES])
def test_ring_edges_match_plain_and_repeat_bit_for_bit(cuda, b, sq, sk, h,
                                                       causal, d):
    """At the ring's edges, with q, k, v the ``qkv.unbind(2)`` views of
    one packed projection where sq == sk (read in place): the forward,
    the split dq and dk/dv and (sq == sk) the fused backward against their
    plain versions; every output the same bits on a second launch and the
    same bits as from contiguous copies of q, k and v."""
    g = torch.Generator(device="cpu").manual_seed(11)
    mk = lambda *shape: torch.randn(*shape, generator=g).to(cuda,
                                                            torch.bfloat16)
    if sq == sk:
        q, k, v = mk(b, sq, 3, h, d).unbind(2)
        assert all(fa.reads_in_place(t) for t in (q, k, v))
    else:
        q, k, v = mk(b, sq, h, d), mk(b, sk, h, d), mk(b, sk, h, d)
    do = mk(b, sq, h, d)
    out, lse = fa.flash_fwd(q, k, v, causal)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
    _close(out, ref_out, "out")
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    delta = fa.bwd_delta(do, out)
    calls = {
        "forward": lambda q, k, v: fa.flash_fwd(q, k, v, causal),
        "dq": lambda q, k, v: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                              causal),
        "dk/dv": lambda q, k, v: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  causal),
    }
    if sq == sk:
        calls["fused"] = lambda q, k, v: fa.flash_bwd_fused(q, k, v, do, lse,
                                                            causal)
    _close(calls["dq"](q, k, v),
           fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal), "dq")
    for got, ref, name in zip(
            calls["dk/dv"](q, k, v),
            fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal),
            ("dk", "dv")):
        _close(got, ref, name)
    if sq == sk:
        for got, ref, name in zip(
                calls["fused"](q, k, v),
                fa.flash_bwd_fused_plain(q, k, v, do, lse, causal),
                ("dq", "dk", "dv")):
            _close(got, ref, "fused " + name)
    copies = [t.contiguous() for t in (q, k, v)]
    for name, fn in calls.items():
        first = fn(q, k, v)
        first = first if isinstance(first, tuple) else (first,)
        for again in (fn(q, k, v), fn(*copies)):
            again = again if isinstance(again, tuple) else (again,)
            for a, c in zip(first, again):
                assert torch.equal(a, c), name


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


# ------------------- the one-wave int8 quantize and onebit unpack (rows 6-7)
#
# Both launch one wave of 16-byte accesses on a plan that peels a head (x
# may be a view at any 4-byte offset), walks 16-byte vectors and masks a
# tail: every edge of that plan, bit for bit, and each launch twice.

EDGE_SIZES = [1, 3, 4, 15, 16, 17, 31, 32, 33, 1023, 1024, 1025, 4095, 4097,
              1_024_000, 4_096_003]
VIEW_SIZES = [1, 17, 1025, 1_024_000, 4_096_003]


def _quantize_twice(x, s):
    n0 = ob.int8_quantize.launches
    q = ob.int8_quantize(x, s)
    assert ob.int8_quantize.launches == n0 + 1
    q2 = ob.int8_quantize(x, s)
    assert ob.int8_quantize.launches == n0 + 2
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert torch.equal(q, q2)
    return q


def _unpack_twice(words, n):
    n0 = ob.onebit_unpack.launches
    u = ob.onebit_unpack(words, n)
    assert ob.onebit_unpack.launches == n0 + 1
    u2 = ob.onebit_unpack(words, n)
    assert ob.onebit_unpack.launches == n0 + 2
    torch.cuda.synchronize()
    assert u.dtype == torch.float32 and u.shape == (n,)
    assert torch.equal(u.view(torch.int32), u2.view(torch.int32))
    return u


def _words(m, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(-2**31, 2**31, (m,), generator=g, dtype=torch.int64
                         ).to(torch.int32)


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_one_wave_codecs_match_plain_at_every_size(cuda, n):
    g = torch.Generator(device="cpu").manual_seed(n)
    x = (torch.randn(n, generator=g) * 3).to(cuda)
    s = x.abs().max().item() / 127
    assert torch.equal(_quantize_twice(x, s), ob.int8_quantize_plain(x, s))
    words = _words(ob.words_for(n), n).to(cuda)
    assert torch.equal(_unpack_twice(words, n).view(torch.int32),
                       ob.onebit_unpack_plain(words, n).view(torch.int32))


@pytest.mark.parametrize("n", VIEW_SIZES)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_int8_quantize_of_a_misaligned_view_matches_plain(cuda, k, n):
    """x[k:] starts 4k bytes past a 16-byte boundary: a head of 4 - k
    elements, then codes stored 4 - k bytes past q's boundary."""
    g = torch.Generator(device="cpu").manual_seed(100 + n)
    x = (torch.randn(n + k, generator=g) * 3).to(cuda)[k:]
    assert x.data_ptr() % 16 == 4 * k
    s = x.abs().max().item() / 127
    assert torch.equal(_quantize_twice(x, s), ob.int8_quantize_plain(x, s))


@pytest.mark.parametrize("n", VIEW_SIZES)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_onebit_unpack_of_a_words_view_matches_plain(cuda, k, n):
    """words[k:] is read with 4-byte loads at any offset; the floats are
    still stored as aligned 16-byte vectors."""
    words = _words(ob.words_for(n) + k, 200 + n).to(cuda)[k:]
    assert words.data_ptr() % 16 == 4 * k
    assert torch.equal(_unpack_twice(words, n).view(torch.int32),
                       ob.onebit_unpack_plain(words, n).view(torch.int32))


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_int8_quantize_edges_match_plain_in_every_view(cuda, k):
    """Ties at ±0.5, ±2.5 (round half to even), the clamps at ±127, ±0,
    denormals and infinities, at scale 1 and at the vector's amax scale,
    from every 4-byte offset."""
    f = torch.finfo(torch.float32)
    edges = torch.tensor([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 126.5, -126.5,
                          127.4, -127.4, 127.5, -127.5, 128.0, -128.0, 1e9,
                          -1e9, 0.0, -0.0, f.tiny / 4, -f.tiny / 4, f.tiny,
                          -f.tiny, float("inf"), -float("inf"), 3.5, -3.5])
    x = edges.repeat(3).to(cuda)[k:]
    for s in (1.0, 1e9 / 127, 0.0):
        assert torch.equal(_quantize_twice(x, s),
                           ob.int8_quantize_plain(x, s)), s


@pytest.mark.parametrize("s", [1.0, 0.0037, 3.3e-9, 2.2e7, 1e-40, 3e38])
def test_int8_quantize_near_ties_match_the_exact_divide(cuda, s):
    """x = (k + 1/2) · s and its neighbours up to 6 ulps away, k in
    -140..140: where x · RN(1 / s) and the correctly rounded x / s round
    to other integers, the kernel must take the divide. 1e-40 and 3e38
    have no normal reciprocal (every element takes the divide)."""
    import numpy as np
    with np.errstate(over="ignore"):       # 3e38 · 140 is inf: an input too
        ties = ((np.arange(-140, 141) + 0.5) * np.float64(np.float32(s))
                ).astype(np.float32)
    xs, up, down = [ties], ties, ties
    for _ in range(6):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        xs += [up, down]
    x = torch.from_numpy(np.concatenate(xs)).to(cuda)
    assert torch.equal(_quantize_twice(x, s), ob.int8_quantize_plain(x, s))


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_onebit_unpack_edges_match_plain_in_every_view(cuda, k):
    """Words of no bit, every bit, the sign bit alone, the lowest bit
    alone and alternating bits, from every 4-byte offset, at sizes ending
    mid-word and mid-vector."""
    words = torch.tensor([0, -1, -2**31, 1, 0x55555555, -0x55555556, 0, -1],
                         dtype=torch.int32).repeat(4).to(cuda)[k:]
    for n in (1, 2, 5, 32 * words.numel() - 3, 32 * words.numel()):
        assert torch.equal(_unpack_twice(words, n).view(torch.int32),
                           ob.onebit_unpack_plain(words, n).view(torch.int32))


def test_one_wave_codecs_on_a_stride_of_waves(cuda):
    """An n past one wave (132 SMs · 4 CTAs · 1,024 vectors for quantize)
    walks the grid in a stride loop."""
    n = 3 * ob._sms(cuda) * ob.CTAS_PER_SM * ob.CTA_THREADS * 16 + 5
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(n + 1, generator=g).to(cuda)[1:]
    s = x.abs().max().item() / 127
    assert ob.stream_plan(n, x.data_ptr() % 16, ob._sms(cuda), 4,
                          ob.QUANT_VECS).grid == ob._sms(cuda) * ob.CTAS_PER_SM
    assert torch.equal(_quantize_twice(x, s), ob.int8_quantize_plain(x, s))
    words = ob.onebit_pack(x)
    assert torch.equal(_unpack_twice(words, n).view(torch.int32),
                       ob.onebit_unpack_plain(words, n).view(torch.int32))


# ------------------------- the one-wave onebit pack and fp8 SR (rows 5, 9)
#
# Both launch one wave of 16-byte loads on the same plan (pack: a 4-byte-load
# instance for a view at a 4-byte offset, whose float4s would straddle
# words); fp8 SR divides by the host's RN(1 / s) and one fma correction
# inside a guard, by __fdiv_rn outside it. Every edge, bit for bit, each
# launch twice; near-carry vectors, where a quotient one ulp off changes
# bytes, and the guard's edges.

PACK_FP8_SIZES = [1, 3, 4, 31, 32, 33, 127, 128, 129, 1023, 1025, 4097,
                  1_024_000, 4_096_003]


def _twice(fn, counter):
    n0 = counter.launches
    a = fn()
    assert counter.launches == n0 + 1
    b = fn()
    assert counter.launches == n0 + 2
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    return a


def _pack_and_fp8_match_plain(x):
    from byteps_tpu_torch.ops.compression import fp8sr
    words = _twice(lambda: ob.onebit_pack(x), ob.onebit_pack)
    assert words.dtype == torch.int32 and words.numel() == ob.words_for(
        x.numel())
    assert torch.equal(words, ob.onebit_pack_plain(x))
    amax = x.abs().max().item()
    for kind in (fp8sr.E4M3, fp8sr.E5M2):
        s = amax / fp8sr.fmt_max(kind)
        q = _twice(lambda: ob.fp8_sr_quantize(x, s, 99, kind),
                   ob.fp8_sr_quantize)
        assert q.dtype == torch.uint8 and q.shape == x.shape
        assert torch.equal(q, ob.fp8_sr_quantize_plain(x, s, 99, kind)), kind


@pytest.mark.parametrize("n", PACK_FP8_SIZES)
def test_pack_and_fp8_match_plain_at_every_size(cuda, n):
    g = torch.Generator(device="cpu").manual_seed(300 + n)
    x = torch.randn(n, generator=g) * 3
    x[torch.randint(0, n, (n // 5,), generator=g)] = 0.0   # zeros of both signs
    x[torch.randint(0, n, (n // 9,), generator=g)] = -0.0
    _pack_and_fp8_match_plain(x.to(cuda))


@pytest.mark.parametrize("n", VIEW_SIZES)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_pack_and_fp8_of_a_misaligned_view_match_plain(cuda, k, n):
    """x[k:] starts 4k bytes past a 16-byte boundary: pack takes its
    4-byte-load instance, fp8 SR peels a head of 4 - k elements and stores
    its codes 4 - k bytes past q's boundary."""
    g = torch.Generator(device="cpu").manual_seed(400 + n)
    x = (torch.randn(n + k, generator=g) * 3).to(cuda)[k:]
    assert x.data_ptr() % 16 == 4 * k
    _pack_and_fp8_match_plain(x)


def test_pack_and_fp8_on_a_stride_of_waves(cuda):
    """An n past one wave walks the grid in a stride loop: pack's 132 SMs ·
    4 CTAs · 2,048 float4s, three times over, from an aligned x (and its
    4-byte-load instance twelve times over from x[1:])."""
    n = 3 * ob._sms(cuda) * ob.CTAS_PER_SM * ob.CTA_THREADS * 4 * ob.PACK_VECS
    g = torch.Generator(device="cpu").manual_seed(6)
    x = torch.randn(n + 5, generator=g).to(cuda)
    for xv in (x[:n + 3], x[1:]):
        assert ob.pack_plan(xv.numel(), xv.data_ptr() % 16,
                            ob._sms(cuda)).grid == \
            ob._sms(cuda) * ob.CTAS_PER_SM
        _pack_and_fp8_match_plain(xv)


@pytest.mark.parametrize("s", smoke.FP8_CARRY_SCALES,
                         ids=["pow2", "all-ones", "no-normal-recip",
                              "subnormal"])
@pytest.mark.parametrize("seed", [0, 0xFFFFFFFF, 1234])
@pytest.mark.parametrize("kind", [0, 1], ids=["e4m3", "e5m2"])
def test_fp8_near_carry_vectors_match_the_exact_divide(cuda, kind, seed, s):
    """Where a quotient's low bits plus the noise land within one of a
    carry, a divide one ulp off flips the byte (random vectors almost
    never show it): ``chip_smoke.fp8_near_carry``, from x[0] and from
    x[1:], the noise designed for the view's indices. 3e38 and the
    subnormal 1e-40 have no normal RN(1/s): every element takes the
    divide."""
    import numpy as np
    xn = smoke.fp8_near_carry(1 << 17, s, seed, kind,
                              np.random.default_rng(seed % 1000 + kind))
    for k in (0, 1):
        x = torch.from_numpy(np.concatenate([np.zeros(k, np.float32), xn])
                             ).to(cuda)[k:]
        q = _twice(lambda: ob.fp8_sr_quantize(x, s, seed, kind),
                   ob.fp8_sr_quantize)
        assert torch.equal(q, ob.fp8_sr_quantize_plain(x, s, seed, kind)), k


@pytest.mark.parametrize("s", smoke.FP8_EDGE_SCALES)
@pytest.mark.parametrize("kind", [0, 1], ids=["e4m3", "e5m2"])
def test_fp8_sr_at_the_divide_guards_edges_matches_plain(cuda, kind, s):
    """``chip_smoke.fp8_guard_edges``: x at the guard's bounds, at
    2^-100, x / s at the clip and near fp32 overflow, the formats'
    smallest normals and subnormal quanta times s, each with its
    neighbours, ±0 and ±inf; from every 4-byte offset, two seeds."""
    import numpy as np
    xn = np.tile(smoke.fp8_guard_edges(s, kind), 3)
    for k in range(4):
        x = torch.from_numpy(np.concatenate([np.zeros(k, np.float32), xn])
                             ).to(cuda)[k:]
        for seed in (0, 1234):
            q = _twice(lambda: ob.fp8_sr_quantize(x, s, seed, kind),
                       ob.fp8_sr_quantize)
            assert torch.equal(q, ob.fp8_sr_quantize_plain(x, s, seed, kind)), \
                (k, seed)


# ------------------------------------ the one-wave int8 dequantize (row 8)
#
# One wave of float4 stores on the output's plan (no head); codes from one
# aligned word a float4 where q is 4-byte aligned, four 1-byte loads from a
# view q[k:] at any other offset, the instance picked by the wrapper.
# out = RN((float) q · s), bit for bit, each launch twice.

def _dequantize_twice(q, s):
    d = _twice(lambda: ob.int8_dequantize(q, s).view(torch.int32),
               ob.int8_dequantize)
    assert d.shape == q.shape
    return d


def _codes(n, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(-127, 128, (n,), generator=g, dtype=torch.int8)


@pytest.mark.parametrize("n", VIEW_SIZES)
@pytest.mark.parametrize("k", range(16))
def test_int8_dequantize_of_a_view_matches_plain(cuda, k, n, monkeypatch):
    """q[k:] starts k bytes past a 16-byte boundary: the wrapper passes
    the C entry the word instance for k % 4 == 0, the byte instance
    otherwise; out is the wrapper's own, aligned."""
    real, picked = ob.entry, []

    def spy(stem):
        fn = real(stem)
        if stem != "int8_dequantize":
            return fn
        return lambda *a: picked.append(a[5]) or fn(*a)

    monkeypatch.setattr(ob, "entry", spy)
    q = _codes(n + k, 500 + n).to(cuda)[k:]
    assert q.data_ptr() % 16 == k
    s = 3.7 / 127
    assert torch.equal(_dequantize_twice(q, s),
                       ob.int8_dequantize_plain(q, s).view(torch.int32))
    assert picked == [int(k % 4 == 0)] * 2


@pytest.mark.parametrize("n", VIEW_SIZES)
def test_int8_dequantize_instances_agree_on_an_aligned_q(cuda, n):
    """Forced through the C entry on an aligned q, the byte instance gives
    the word instance's bits, and both the plain version's."""
    from byteps_tpu_torch.ops import _build
    fn = _build.entry("int8_dequantize")
    q = _codes(n, 900 + n).to(cuda)
    plan = ob.stream_plan(n, 0, ob._sms(cuda), 4, ob.DEQUANT_VECS)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    s = 3.7 / 127
    want = ob.int8_dequantize_plain(q, s).view(torch.int32)
    for words in (1, 0):
        out = torch.empty(n, device=cuda)
        _build.raise_on_error(fn(q.data_ptr(), out.data_ptr(), n, plan.vecs,
                                 plan.grid, words, s, stream),
                              f"int8 dequantize, words {words}")
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), want), words


@pytest.mark.parametrize("k", [0, 1])
def test_int8_dequantize_on_a_stride_of_waves(cuda, k):
    """One wave (132 SMs · 4 CTAs · 2,048 float4s) and one float4 more,
    then a tail of 1: CTA 0 walks a second pass and writes the tail; both
    instances."""
    wave = ob._sms(cuda) * ob.CTAS_PER_SM * ob.CTA_THREADS * ob.DEQUANT_VECS
    n = 4 * wave + 5
    q = _codes(n + k, 7).to(cuda)[k:]
    plan = ob.stream_plan(n, 0, ob._sms(cuda), 4, ob.DEQUANT_VECS)
    assert plan == ob.StreamPlan(0, wave + 1, 1, ob._sms(cuda) *
                                 ob.CTAS_PER_SM)
    s = 0.0123
    assert torch.equal(_dequantize_twice(q, s),
                       ob.int8_dequantize_plain(q, s).view(torch.int32))


@pytest.mark.parametrize("s", [3.7 / 127, 1.0, 0.0, 1e-30, 1e-40],
                         ids=["amax", "one", "zero", "tiny", "subnormal"])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_int8_dequantize_edges_match_plain_in_every_view(cuda, k, s):
    """The codes ±127, 0 and -1 (and all 255 codes) at the codec's scale,
    1, 0 (the scale is taken as given), 1e-30 and the subnormal 1e-40,
    whose products with |q| <= 117 stay subnormal (no flush to zero),
    from every byte offset."""
    codes = torch.tensor([127, -127, 0, -1, 1], dtype=torch.int8)
    q = torch.cat([codes.repeat(7), torch.arange(-127, 128).to(torch.int8)
                   ]).to(cuda)[k:]
    d = _dequantize_twice(q, s)
    assert torch.equal(d, ob.int8_dequantize_plain(q, s).view(torch.int32))
    if s == 1e-40:
        f = d.view(torch.float32)
        assert (f[q != 0] != 0).all()      # no product flushed to zero


def test_int8_dequantize_entry_refuses_what_its_plan_does_not_cover(cuda):
    """The C entry returns cudaErrorInvalidValue (1), and launches
    nothing, for a plan that does not cover [0, n) as vecs float4s and a
    tail of 0-3, a misaligned out, no CTA, or the word instance on a q
    that is not 4-byte aligned."""
    from byteps_tpu_torch.ops import _build
    fn = _build.entry("int8_dequantize")
    n = 17
    q = _codes(n + 1, 3).to(cuda)
    qa, o = q.data_ptr(), torch.full((n + 4,), 7.0, device=cuda)
    out = o.data_ptr()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    bad = [(qa, out, n, 5, 1, 1),        # 20 elements > 17
           (qa, out, n, 3, 1, 1),        # a tail of 5
           (qa, out, n, -1, 1, 1),
           (qa, out, 0, 0, 1, 1),
           (qa, out, n, 4, 0, 1),        # no CTA
           (qa, out + 4, n, 4, 1, 1),    # out misaligned
           (qa + 1, out, n, 4, 1, 1)]    # words from a misaligned q
    for args in bad:
        assert fn(*args, 1.0, stream) == 1, args
    torch.cuda.synchronize()
    assert (o == 7.0).all()
    assert fn(qa + 1, out, n, 4, 1, 0, 1.0, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(o[:n], q[1:].to(torch.float32))
    assert fn(qa, out, n, 4, 1, 1, 1.0, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(o[:n], q[:n].to(torch.float32))


# ------------------------------------- bias and rel-table forms (rows 1, 3, 4)

FORM_CASES = [  # (b, sq, sk, h, causal, form, nb, max_distance)
    (2, 128, 128, 4, False, "rel", 32, 128),
    (2, 256, 256, 4, True, "rel", 32, 128),
    (2, 128, 256, 4, False, "rel", 32, 128),     # sq != sk
    (1, 512, 512, 8, False, "rel", 128, 512),
    (2, 1024, 1024, 2, True, "rel", 32, 128),
    (2, 1024, 1024, 2, False, "rel", 128, 128),
    (2, 128, 256, 4, False, "bias", 0, 0),       # sq != sk
    (2, 512, 192, 2, False, "bias", 0, 0),
    (2, 256, 256, 4, True, "bias", 0, 0),
    (1, 1024, 1024, 2, False, "bias", 0, 0),
]


def _form_kw(dev, form, h, sq, sk, causal, nb, maxd, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    if form == "bias":
        return {"bias": torch.randn(h, sq, sk, generator=g).to(dev)}
    return {"rel_table": torch.randn(h, nb, generator=g).to(dev),
            "rel_bidirectional": not causal, "rel_max_distance": maxd}


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize(
    "b,sq,sk,h,causal,form,nb,maxd", FORM_CASES,
    ids=[f"{c[5]}-b{c[0]}-q{c[1]}-k{c[2]}-h{c[3]}-"
         f"{'causal' if c[4] else 'full'}" + (f"-nb{c[6]}" if c[6] else "")
         for c in FORM_CASES])
def test_bias_forms_match_plain(cuda, b, sq, sk, h, causal, form, nb, maxd,
                                d):
    """Forward, dq (with dbias or dtable) and dk/dv of each form."""
    q, k, v, do = _inputs(cuda, b, sq, sk, h, seed=40, d=d)
    kw = _form_kw(cuda, form, h, sq, sk, causal, nb, maxd, seed=41)
    attr = "launches_bias" if form == "bias" else "launches_rel"
    fns = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    n0 = [getattr(f, attr) for f in fns]
    nd = [getattr(f, attr + "_d")[d] for f in fns]
    out, lse = fa.flash_fwd(q, k, v, causal, **kw)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal, **kw)
    _close(out, ref_out, "out")
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    delta = fa.bwd_delta(do, ref_out)
    dq, dgrad = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal, **kw)
    torch.cuda.synchronize()
    assert [getattr(f, attr) - c for f, c in zip(fns, n0)] == [1, 1, 1]
    assert [getattr(f, attr + "_d")[d] - c
            for f, c in zip(fns, nd)] == [1, 1, 1]
    ref_dq, ref_dgrad = fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta,
                                              causal, **kw)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta,
                                            causal, **kw)
    assert dgrad.dtype == torch.float32 and dgrad.shape == ref_dgrad.shape
    for got, ref, name in ((dq, ref_dq, "dq"), (dk, ref_dk, "dk"),
                           (dv, ref_dv, "dv"), (dgrad, ref_dgrad, form)):
        _close(got, ref, name)


@pytest.mark.parametrize("d", WIDTHS)
def test_dense_and_table_forms_agree_bit_for_bit(cuda, d):
    """The same fp32 bias values, once as the table and once materialized:
    the same addend in the same code, so the same bits."""
    from byteps_tpu_torch.ops import relpos
    b, s, h = 2, 256, 4
    q, k, v, do = _inputs(cuda, b, s, s, h, seed=42, d=d)
    table = torch.randn(h, 32, generator=torch.Generator().manual_seed(43))
    table = table.to(cuda)
    for causal in (False, True):
        rel = {"rel_table": table, "rel_bidirectional": not causal}
        dense = {"bias": relpos.relative_bias(table.T, s, s, not causal)}
        out_t, lse_t = fa.flash_fwd(q, k, v, causal, **rel)
        out_d, lse_d = fa.flash_fwd(q, k, v, causal, **dense)
        assert torch.equal(out_t, out_d) and torch.equal(lse_t, lse_d)
        delta = fa.bwd_delta(do, out_t)
        dq_t, _ = fa.flash_bwd_dq(q, k, v, do, lse_t, delta, causal, **rel)
        dq_d, _ = fa.flash_bwd_dq(q, k, v, do, lse_t, delta, causal, **dense)
        assert torch.equal(dq_t, dq_d)
        for a, c in zip(fa.flash_bwd_dkv(q, k, v, do, lse_t, delta, causal,
                                         **rel),
                        fa.flash_bwd_dkv(q, k, v, do, lse_t, delta, causal,
                                         **dense)):
            assert torch.equal(a, c)


@pytest.mark.parametrize("d", WIDTHS)
def test_dtable_is_the_same_bits_on_every_launch(cuda, d):
    q, k, v, do = _inputs(cuda, 2, 512, 512, 4, seed=44, d=d)
    table = torch.randn(4, 32, generator=torch.Generator().manual_seed(45))
    kw = {"rel_table": table.to(cuda), "rel_bidirectional": True}
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.bwd_delta(do, out)
    first = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    for _ in range(3):
        again = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        assert torch.equal(first[0], again[0])
        assert torch.equal(first[1], again[1])


@pytest.mark.parametrize("d", WIDTHS)
def test_dbias_of_causally_skipped_tiles_is_zero(cuda, d):
    """The dq kernel skips key tiles above the diagonal; their dbias must
    read 0, not what the buffer held."""
    s, h = 256, 2
    q, k, v, do = _inputs(cuda, 2, s, s, h, seed=46, d=d)
    bias = torch.randn(h, s, s, generator=torch.Generator().manual_seed(47))
    torch.full((2, h, s, s), float("nan"), device=cuda)   # dirty the pool
    out, lse = fa.flash_fwd(q, k, v, True, bias=bias.to(cuda))
    _, dbias = fa.flash_bwd_dq(q, k, v, do, lse, fa.bwd_delta(do, out), True,
                               bias=bias.to(cuda))
    above = ~torch.ones(s, s, dtype=torch.bool, device=cuda).tril()
    assert torch.isfinite(dbias).all()
    assert (dbias[:, above] == 0).all()


def test_table_buckets_on_the_exact_log_boundaries(cuda):
    """Offsets |n| = 16, 32 and 64 sit exactly on bucket boundaries in
    float32 (bidirectional, 32 buckets, max distance 128): their true
    buckets are 10, 12 and 14 a side. The table is 0 but for +8 on the
    buckets one below (9, 11, 13 and 25, 27, 29), and q = k = 0, so each
    score is its bias alone: an offset put one bucket low would change the
    lse by far more than its tolerance."""
    from byteps_tpu_torch.ops import relpos
    b, s, h = 1, 256, 2
    rel = torch.tensor([-64, -32, -16, 16, 32, 64], dtype=torch.int32)
    assert relpos.relative_position_bucket(rel, True).tolist() == \
        [14, 12, 10, 26, 28, 30]
    zero = torch.zeros(b, s, h, 64, device=cuda, dtype=torch.bfloat16)
    v = _inputs(cuda, b, s, s, h, seed=48)[2]
    table = torch.zeros(h, 32, device=cuda)
    table[:, [9, 11, 13, 25, 27, 29]] = 8.0
    out, lse = fa.flash_fwd(zero, zero, v, rel_table=table)
    ref_out, ref_lse = fa.flash_fwd_plain(zero, zero, v, rel_table=table)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    _close(out, ref_out, "out")


def test_bias_forms_read_strided_views_in_place(cuda):
    g = torch.Generator(device="cpu").manual_seed(49)
    qkv = torch.randn(2, 192, 3, 4, 64, generator=g).to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(2, 192, 4, 64, generator=g).to(cuda, torch.bfloat16)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    for kw in ({"rel_table": torch.randn(4, 32, generator=g).to(cuda)},
               {"bias": torch.randn(4, 192, 192, generator=g).to(cuda)}):
        out, lse = fa.flash_fwd(q, k, v, **kw)
        out_c, lse_c = fa.flash_fwd(qc, kc, vc, **kw)
        assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
        delta = fa.bwd_delta(do, out)
        for a, c in zip(fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                        fa.flash_bwd_dq(qc, kc, vc, do, lse, delta, **kw)):
            assert torch.equal(a, c)
        for a, c in zip(fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
                        fa.flash_bwd_dkv(qc, kc, vc, do, lse, delta, **kw)):
            assert torch.equal(a, c)


@pytest.mark.parametrize("form", ["rel", "bias"])
def test_autograd_returns_the_bias_and_table_gradients(cuda, form):
    """The autograd Function with a bias or table takes the split kernels
    even at one block, and returns d(bias) or d(table) beside dq, dk, dv,
    against autograd of the plain forward."""
    b, s, h = 2, 256, 4
    q, k, v, do = _inputs(cuda, b, s, s, h, seed=50)
    g = torch.Generator().manual_seed(51)
    extra = (torch.randn(h, 32, generator=g) if form == "rel"
             else torch.randn(h, s, s, generator=g)).to(cuda)
    name = "rel_table" if form == "rel" else "bias"
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, extra)]
    names = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
    n0 = [getattr(fa, n).launches for n in names]
    fa.attention(*leaves[:3], **{name: leaves[3]}).backward(do)
    torch.cuda.synchronize()
    assert [getattr(fa, n).launches - c for n, c in zip(names, n0)] == \
        [1, 0, 1, 1]
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v, extra)]
    fa.flash_fwd_plain(*ref[:3], **{name: ref[3]})[0].backward(do)
    for got, want, label in zip(leaves, ref, ("dq", "dk", "dv", "d" + name)):
        _close(got.grad, want.grad, label, rel=3e-2)


def test_cuda_bias_forms_the_kernels_do_not_take_raise(cuda):
    q = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16)
    n0 = fa.flash_fwd.launches
    with pytest.raises(ValueError, match="at most 128"):
        fa.flash_fwd(q, q, q, rel_table=torch.zeros(2, 129, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        fa.flash_fwd(q, q, q, rel_table=torch.zeros(
            2, 32, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="different devices"):
        fa.flash_fwd(q, q, q, bias=torch.zeros(2, 64, 64))
    assert fa.flash_fwd.launches == n0


# ------------------------------------------- the model options (the LM head,
# the save_attn policy's op, the long-context shapes)

def test_head_gemm_matches_the_fp32_route(cuda):
    """The LM head's bf16 x bf16 -> fp32 GEMM (``_HeadGemm``) against the
    fp32 product of the same rounded operands (the CPU's route, run on
    the card with TF32 off), at a GPT-2-like head with an odd vocabulary
    (the GEMM pads it to a multiple of 8): logits within 1e-5 ·
    max|ref| (the same products, fp32 sums in another order); dh and dE
    within 1e-2 · max|ref| (the route rounds the fp32 cotangent to bf16,
    one bf16 step of each product)."""
    from byteps_tpu_torch.models import transformer as tr
    g = torch.Generator().manual_seed(11)
    h = torch.randn(2, 256, 1024, generator=g).to(cuda, torch.bfloat16)
    emb = (torch.randn(4097, 1024, generator=g) * 0.02).to(cuda)
    ct = torch.randn(2, 256, 4097, generator=g).to(cuda) * 1e-3
    ha, ea = h.clone().requires_grad_(), emb.clone().requires_grad_()
    lg = tr.head_logits(ha, ea, torch.bfloat16)
    assert lg.dtype == torch.float32
    lg.backward(ct)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        hb, eb = h.clone().requires_grad_(), emb.clone().requires_grad_()
        ref = hb.to(torch.bfloat16).float() @ eb.to(torch.bfloat16).float().t()
        ref.backward(ct)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    _close(lg, ref, "logits", rel=1e-5)
    _close(ha.grad, hb.grad, "dh")
    _close(ea.grad, eb.grad, "dE")


def test_save_attn_launches_the_forward_once_never_the_plain_version(
        cuda, monkeypatch):
    """A ``save_attn`` model on CUDA tensors: the forward kernel once a
    layer (the recompute reads the kept (out, lse)), the plain forward
    never."""
    from byteps_tpu_torch.models import transformer as tr

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain forward")

    monkeypatch.setattr(fa, "flash_fwd_plain", refuse)
    cfg = tr.TransformerConfig(vocab_size=256, hidden=128, layers=2, heads=2,
                               mlp_dim=512, max_seq=128, causal=True,
                               remat_policy="save_attn")
    model = tr.Transformer(cfg).to(cuda)
    tokens = torch.randint(1, 256, (2, 128), device=cuda)
    fa.zero_counts(fa.flash_fwd)
    tr.lm_loss(model, (tokens, tokens)).backward()
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == cfg.layers
    assert all(p.grad is not None for p in model.parameters())


LONG_SEQ = 32768


def test_kernels_at_seq_32768_match_plain_per_head(cuda):
    """The forward, dq and dk/dv kernels at GPT-2's long context (b 1, s
    32768, causal, d 64) on two heads, each head held against the plain
    version run on that head alone (its fp32 scores are 4.3 GB)."""
    q, k, v, do = _inputs(cuda, 1, LONG_SEQ, LONG_SEQ, 2, seed=5)
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.bwd_delta(do, out)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    for i in range(2):
        sl = slice(i, i + 1)
        qh, kh, vh, doh = (t[:, :, sl] for t in (q, k, v, do))
        ref_out, ref_lse = fa.flash_fwd_plain(qh, kh, vh, True)
        _close(out[:, :, sl], ref_out, f"out head {i}")
        assert (lse[:, sl] - ref_lse).abs().max().item() <= 1e-3
        del ref_out, ref_lse
        ref_dq = fa.flash_bwd_dq_plain(qh, kh, vh, doh, lse[:, sl],
                                       delta[:, sl], True)
        _close(dq[:, :, sl], ref_dq, f"dq head {i}")
        del ref_dq
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(qh, kh, vh, doh, lse[:, sl],
                                                delta[:, sl], True)
        _close(dk[:, :, sl], ref_dk, f"dk head {i}")
        _close(dv[:, :, sl], ref_dv, f"dv head {i}")
        del ref_dk, ref_dv
        torch.cuda.empty_cache()
