"""The port's flash attention held against the JAX package's Pallas
kernels, on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions — the
same function the Hopper kernels compute — and the JAX kernels run in
Pallas interpret mode, as ``tests/test_flash_attention.py`` runs them. The
same numpy inputs, made from a seed, go through both. Shapes are one
block per (batch, head): b 2, s 128 and 256, h 4, d 64, fp32.

Tolerance 1e-5 (fp32): the two sides compute the same fp32 arithmetic and
differ only in summation order.

The CUDA kernels themselves have no CPU mode; their checks against these
plain versions are ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops import flash_attention as jfa
from byteps_tpu_torch.ops import flash_attention as tfa
from byteps_tpu_torch.parallel.ring import local_attention

TOL = dict(rtol=1e-5, atol=1e-5)
B, H, D = 2, 4, 64


@pytest.fixture(autouse=True)
def _cpu_numerics():
    """Full fp32 matmuls (the tolerances below assume them, whatever an
    earlier test in this worker set) and 2 torch threads (the suite runs
    in parallel workers)."""
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _qkv(seed, s, sk=None):
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    q = rng.randn(B, s, H, D).astype(np.float32)
    k = rng.randn(B, sk, H, D).astype(np.float32)
    v = rng.randn(B, sk, H, D).astype(np.float32)
    do = rng.randn(B, s, H, D).astype(np.float32)
    return q, k, v, do


def _bhsd(x):                 # [b, s, h, d] numpy -> [b, h, s, d] jax
    return jnp.asarray(np.swapaxes(x, 1, 2))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_pallas_fwd(s, causal):
    q, k, v, _ = _qkv(0, s)
    scale = D ** -0.5
    jout, jlse = jfa._flash_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale,
                                s, s, True)
    before = tfa.flash_fwd.launches
    out, lse = tfa.flash_fwd(_t(q), _t(k), _t(v), causal)
    assert tfa.flash_fwd.launches == before      # CPU: the plain version
    assert out.shape == (B, s, H, D) and lse.shape == (B, H, s)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.swapaxes(np.asarray(jout), 1, 2),
                               **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], **TOL)


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_fused_backward_matches_pallas_fused(s, causal):
    """(q, k, v, dO, lse) -> (dq, dk, dv) with no ``out``: delta comes
    from P∘dP on both sides."""
    q, k, v, do = _qkv(1, s)
    scale = D ** -0.5
    _, jlse = jfa._flash_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale,
                             s, s, True)
    jdq, jdk, jdv = jfa._flash_bwd_fused(_bhsd(q), _bhsd(k), _bhsd(v), jlse,
                                         _bhsd(do), None, causal, scale, s, s,
                                         True, 1)
    lse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    before = tfa.flash_bwd_fused.launches
    dq, dk, dv = tfa.flash_bwd_fused(_t(q), _t(k), _t(v), _t(do), lse, causal)
    assert tfa.flash_bwd_fused.launches == before
    for got, ref, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        np.testing.assert_allclose(got.numpy(),
                                   np.swapaxes(np.asarray(ref), 1, 2),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_autograd_matches_jax_interpret(causal):
    """The autograd Function end to end (plain versions on the CPU) against
    the JAX custom_vjp in interpret mode: value and all three grads."""
    s = 128
    q, k, v, _ = _qkv(2, s)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal, None, s, s, True)
        return jnp.sum(jnp.sin(o))

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    tval = torch.sin(tfa.attention(tq, tk, tv, causal=causal)).sum()
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5)
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=name,
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_naive_impl_is_the_local_attention_oracle(causal):
    q, k, v, _ = _qkv(3, 128)
    ref = local_attention(_t(q), _t(k), _t(v), causal=causal)
    out = tfa.attention(_t(q), _t(k), _t(v), causal=causal, impl="naive")
    flash = tfa.attention(_t(q), _t(k), _t(v), causal=causal)
    assert torch.equal(out, ref)
    np.testing.assert_allclose(flash.numpy(), ref.numpy(), **TOL)


def test_attention_rejects_unknown_and_unported_impls():
    q = torch.zeros(1, 64, 1, 64)
    with pytest.raises(ValueError, match="auto|flash|hybrid|naive"):
        tfa.attention(q, q, q, impl="bogus")
    with pytest.raises(NotImplementedError, match="hybrid"):
        tfa.attention(q, q, q, impl="hybrid")


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_kernel_input_check_accepts_the_flagship_geometry():
    q = _meta(4, 512, 16, 64)
    tfa.check_kernel_inputs(q, q, q, causal=False)
    tfa.check_kernel_inputs(q, q, q, causal=True)


@pytest.mark.parametrize("case,exc,match", [
    ("fp32", TypeError, "bfloat16"),
    ("bias", NotImplementedError, "_dq_kernel"),
    ("rel_table", NotImplementedError, "rel"),
    ("multi_block", NotImplementedError, "split backward"),
    ("head_dim", NotImplementedError, "head_dim"),
    ("ragged", ValueError, "multiples"),
    ("causal_cross", ValueError, "causal"),
])
def test_kernel_input_check_refuses_what_the_kernels_do_not_take(case, exc,
                                                                  match):
    """The CUDA branch of both wrappers calls ``check_kernel_inputs``
    before it launches; what it refuses raises instead of falling back to
    the plain version. Meta tensors stand in for the card's."""
    q = _meta(2, 512, 4, 64)
    k = v = q
    kw = {}
    if case == "fp32":
        q = k = v = _meta(2, 512, 4, 64, dtype=torch.float32)
    elif case == "bias":
        kw["bias"] = _meta(4, 512, 512, dtype=torch.float32)
    elif case == "rel_table":
        kw["rel_table"] = _meta(4, 32, dtype=torch.float32)
    elif case == "multi_block":
        q = k = v = _meta(2, 1024, 4, 64)
    elif case == "head_dim":
        q = k = v = _meta(2, 512, 4, 128)
    elif case == "ragged":
        q = k = v = _meta(2, 200, 4, 64)
    elif case == "causal_cross":
        k = v = _meta(2, 256, 4, 64)
        kw["causal"] = True
    with pytest.raises(exc, match=match):
        tfa.check_kernel_inputs(q, k, v, **kw)


def test_flash_attention_refuses_bias_on_every_device():
    q = torch.zeros(1, 64, 2, 64)
    with pytest.raises(NotImplementedError, match="bias"):
        tfa.flash_attention(q, q, q, bias=torch.zeros(2, 64, 64))


def test_wrapper_refuses_devices_without_a_path():
    q = _meta(1, 64, 1, 64)
    with pytest.raises(RuntimeError, match="no flash attention path"):
        tfa.flash_fwd(q, q, q)
