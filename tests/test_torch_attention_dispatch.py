"""The port's attention dispatcher held against the JAX package's on the
CPU: ``supported()``, the route ``attention`` takes for card shapes (the
kernels wherever they accept the input, a refusal elsewhere, the plain
attention only by name), and
``impl="hybrid"`` (a forward of plain products with the flash backward
kernels behind it).

Card shapes are meta tensors (any device but the CPU counts as the
card's): the route is decided, and the kernels' input check run, without
a card. On the CPU the hybrid backward takes the kernels' plain versions
and the JAX side runs ``flash_attention(..., interpret=True,
fwd_xla=True)``, which is what its ``attention(impl="hybrid")`` calls
with the Pallas kernels in interpret mode (off the TPU they run only
so). The same numpy inputs, made from a seed, go through both.

Tolerances, with their reasons: the forward's out and lse in fp32 1e-5
(the same fp32 arithmetic in another summation order); fp32 gradients
2e-4, those of the repo's other autograd parity tests
(``test_torch_flash_attention.py``, ``test_torch_flash_bias.py``): each
sums up to sk products of terms that already differ in their last bits
(3.4e-5 is the largest difference seen, in dq of the cross case), and the
table's gradient, a sum of dS over the batch and each bucket's positions,
1e-4 · max|ref|; bf16 1e-2 · max|ref| (a value rounded to bf16 may move
one step, 2^-8 relative, and gradients sum many).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops import flash_attention as jfa
from byteps_tpu_torch.ops import flash_attention as tfa

B, H, NB = 2, 4, 32
TOL32 = dict(rtol=1e-5, atol=1e-5)
GRAD32 = dict(rtol=2e-4, atol=2e-4)
REL16 = 1e-2


@pytest.fixture(autouse=True)
def _cpu_numerics(monkeypatch):
    monkeypatch.delenv("BPS_FLASH_FUSED_BWD", raising=False)
    monkeypatch.delenv("BPS_FLASH_BQ", raising=False)
    monkeypatch.delenv("BPS_FLASH_BK", raising=False)
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _meta(b, s, h, d, dtype=torch.bfloat16):
    return torch.empty(b, s, h, d, dtype=dtype, device="meta")


SEQS = (64, 127, 128, 192, 256, 512, 1000, 1024)
DIMS = (16, 64, 128, 200, 256, 300)


@pytest.mark.parametrize("d", DIMS)
def test_supported_is_the_jax_predicate(d):
    for sq in SEQS:
        for sk in (None,) + SEQS:
            q = (2, sq, 4, d)
            k = None if sk is None else (2, sk, 4, d)
            assert tfa.supported(q, k) == jfa.supported(q, k), (q, k)


def test_auto_takes_the_kernels_for_every_supported_card_shape():
    for s, h, d in ((128, 16, 64), (512, 16, 64), (512, 8, 128),
                    (1024, 16, 64)):
        q = _meta(2, s, h, d)
        assert tfa.route(q, q, q) == "flash"
        assert tfa.route(q, q, q, "auto", causal=True) == "flash"
    kv = _meta(2, 1024, 8, 64)
    q = _meta(2, 512, 8, 64)
    assert tfa.route(q, kv, kv, rel_table=None) == "flash"       # cross
    table = torch.empty(8, NB, device="meta")
    assert tfa.route(q, q, q, rel_table=table) == "flash"
    assert tfa.route(q, q, q, "hybrid", rel_table=table) == "hybrid"


@pytest.mark.parametrize("impl", ["auto", "flash", "hybrid"])
@pytest.mark.parametrize("sq,sk,d", [(64, 64, 64), (192, 192, 64),
                                     (320, 320, 128), (512, 192, 64),
                                     (192, 1024, 128)])
def test_auto_takes_the_kernels_for_card_shapes_supported_rejects(impl, sq,
                                                                  sk, d):
    """``supported()`` wants sequences in 128s; the kernels take them in
    64s. A card shape between the two runs the kernels, never the plain
    attention."""
    q, kv = _meta(2, sq, 4, d), _meta(2, sk, 4, d)
    assert not tfa.supported(q.shape, kv.shape)
    assert tfa.route(q, kv, kv, impl) == ("flash" if impl == "auto"
                                          else impl)


@pytest.mark.parametrize("impl", ["auto", "flash", "hybrid"])
@pytest.mark.parametrize("sq,sk,d,exc,match", [
    (1000, 1000, 64, ValueError, "multiples of 64"),
    (127, 127, 64, ValueError, "multiples of 64"),
    (512, 1000, 64, ValueError, "multiples of 64"),
    (128, 128, 320, NotImplementedError, "head_dim 320"),
])
def test_auto_raises_for_card_shapes_the_kernels_refuse(impl, sq, sk, d,
                                                        exc, match):
    """Shapes neither ``supported()`` nor the kernels take raise on the
    card; the plain attention runs only when asked for by name."""
    q, kv = _meta(2, sq, 4, d), _meta(2, sk, 4, d)
    assert not tfa.supported(q.shape, kv.shape)
    with pytest.raises(exc, match=match):
        tfa.route(q, kv, kv, impl)
    assert tfa.route(q, kv, kv, "naive") == "naive"


@pytest.mark.parametrize("impl", ["auto", "flash", "hybrid"])
@pytest.mark.parametrize("case,exc,match", [
    ("d16", NotImplementedError, "head_dim 16"),
    ("d256", NotImplementedError, "head_dim 256"),
    ("fp32", TypeError, "bfloat16"),
])
def test_supported_shapes_the_kernels_refuse_still_raise(impl, case, exc,
                                                        match):
    """``supported()`` accepts them, the kernels do not: they raise, and
    never go to the plain attention."""
    q = {"d16": _meta(2, 128, 4, 16), "d256": _meta(2, 512, 2, 256),
         "fp32": _meta(2, 512, 4, 64, torch.float32)}[case]
    assert tfa.supported(q.shape)
    with pytest.raises(exc, match=match):
        tfa.route(q, q, q, impl)


def test_cpu_tensors_keep_the_plain_flash_route():
    """On the CPU "auto" takes the kernels' plain versions at any shape
    (the JAX package's own tests run tiny widths there)."""
    q = torch.zeros(1, 64, 2, 16)
    assert not tfa.supported(q.shape)
    assert tfa.route(q, q, q) == "flash"
    assert tfa.route(q, q, q, "hybrid") == "hybrid"


# ---------------------------------------------------------------- hybrid

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, dtype, sq, sk, d):
    rng = np.random.RandomState(seed)
    jdt, tdt = DT[dtype]
    shapes = [(B, sq, H, d), (B, sk, H, d), (B, sk, H, d), (B, sq, H, d)]
    tin = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(tdt)
           for s in shapes]
    jin = [jnp.asarray(t.float().numpy()).astype(jdt) for t in tin]
    return jin, tin, rng.randn(H, NB).astype(np.float32), \
        rng.randn(H, sq, sk).astype(np.float32)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, dtype, name, tol=TOL32):
    got, ref = got.detach().float().numpy(), _np(ref)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, err_msg=name, **tol)
    else:
        err = np.abs(got - ref).max()
        assert err <= REL16 * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("biased", [False, True])
def test_hybrid_forward_is_the_jax_xla_fwd(dtype, causal, biased):
    (jq, jk, jv, _), (tq, tk, tv, _), _, bias = _inputs(1, dtype, 128, 128,
                                                        64)
    jout, jlse = jfa._xla_fwd(*(jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)),
                              causal, 64 ** -0.5,
                              bias=jnp.asarray(bias) if biased else None)
    out, lse = tfa.hybrid_fwd(tq, tk, tv, causal,
                              bias=torch.from_numpy(bias) if biased else None)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert lse.dtype == torch.float32 and lse.shape == (B, H, 128)
    _close(out, jnp.swapaxes(jout, 1, 2), dtype, "out")
    np.testing.assert_allclose(lse.numpy(), _np(jlse)[..., 0], **TOL32)


# (name, sq, sk, d, causal, table): BERT-like (one block: the fused
# backward) and T5-like (the table's split backward for the encoder and
# the decoder; cross-attention of one block each way is fused)
CASES = [("bert", 128, 128, 64, False, False),
         ("t5-encoder", 128, 128, 16, False, True),
         ("t5-decoder", 128, 128, 16, True, True),
         ("t5-cross", 128, 256, 16, False, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,sq,sk,d,causal,table", CASES,
                         ids=[c[0] for c in CASES])
def test_hybrid_gradients_are_the_jax_hybrids(name, sq, sk, d, causal, table,
                                              dtype, monkeypatch):
    """``attention(impl="hybrid")`` through autograd against ``jax.vjp``
    of the JAX hybrid: the value, dq, dk, dv and, with T5's table, the
    table's gradient. The forward kernel's wrapper is never called."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), tab, _ = _inputs(
        2, dtype, sq, sk, d)
    scale = 1.0 if name.startswith("t5") else None
    rel = {"rel_bidirectional": not causal}

    def jfn(q, k, v, t):
        return jfa.flash_attention(q, k, v, causal, scale, 512, 512, True,
                                   True, None, t if table else None, **rel)

    jout, vjp = jax.vjp(jfn, jq, jk, jv, jnp.asarray(tab))
    jgrads = vjp(jdo)

    def refuse(*a, **k):
        raise AssertionError("hybrid called the forward kernel's wrapper")
    monkeypatch.setattr(tfa, "flash_fwd", refuse)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    ttab = torch.from_numpy(tab).requires_grad_()
    out = tfa.attention(*leaves, causal=causal, scale=scale, impl="hybrid",
                        rel_table=ttab if table else None, **rel)
    out.backward(tdo)
    _close(out, jout, dtype, "out")
    for got, ref, what in zip(leaves, jgrads, ("dq", "dk", "dv")):
        _close(got.grad, ref, dtype, what, GRAD32)
    if table:
        _close(ttab.grad, jgrads[3], dtype, "dtable",
               dict(rtol=0, atol=1e-4 * np.abs(_np(jgrads[3])).max()))
    else:
        assert ttab.grad is None
