"""The port's split flash-attention backward (``_dq_kernel`` /
``_dkv_kernel``) and its route choice, held against the JAX package on
the CPU.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as ``tests/test_flash_attention.py``
runs them. The same numpy inputs, made from a seed, go through both.
Shapes: b 2, h 2, d 64, s 256 with blocks of 128 each way, so nq = nk = 2
and the backward leaves the fused kernel for the split one.

Tolerances, with their reasons:
  - fp32: 1e-5 (the same fp32 arithmetic, another summation order);
    autograd grads 2e-4, as in ``test_torch_flash_attention.py``;
  - bf16: max |port - jax| <= 2e-2 · max |jax|. Both sides round dS and
    P to bf16 at the same points; an fp32 summation-order difference can
    move a rounded value by one bf16 step (2^-8 relative), and dq / dk sum
    many such values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops import flash_attention as jfa
from byteps_tpu_torch.ops import flash_attention as tfa

B, H, D, S, BLK = 2, 2, 64, 256, 128
TOL32 = dict(rtol=1e-5, atol=1e-5)
REL16 = 2e-2
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _cpu_numerics(monkeypatch):
    """Full fp32 matmuls, 2 torch threads (the suite runs in parallel
    workers), and none of the route's env knobs set."""
    for name in ("BPS_FLASH_BQ", "BPS_FLASH_BK", "BPS_FLASH_FUSED_BWD"):
        monkeypatch.delenv(name, raising=False)
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _inputs(seed, dtype):
    rng = np.random.RandomState(seed)
    _, jdt, tdt = DTYPES[dtype]
    arrs = [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]
    # round once through the working type so both sides see the same values
    torch_in = [torch.from_numpy(a).to(tdt) for a in arrs]
    jax_in = [jnp.asarray(t.float().numpy()).astype(jdt) for t in torch_in]
    return jax_in, torch_in


def _bhsd(x):                 # [b, s, h, d] jax -> [b, h, s, d]
    return jnp.swapaxes(x, 1, 2)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got: torch.Tensor, ref, dtype, name):
    ref = _np(ref)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, err_msg=name, **TOL32)
    else:
        err = np.abs(got - ref).max()
        assert err <= REL16 * np.abs(ref).max(), f"{name}: max err {err}"


# ------------------------------------------------------------------ route

class _Took(Exception):
    pass


def _jax_route(s, monkeypatch):
    """Which backward the JAX custom VJP takes at seq ``s`` (default
    blocks): its fused kernel's wrapper and ``pallas_call`` are replaced
    by tripwires, so nothing runs."""
    def fused(*a, **k):
        raise _Took("fused")

    def split(*a, **k):
        raise _Took("split")

    monkeypatch.setattr(jfa, "_flash_bwd_fused", fused)
    monkeypatch.setattr(jfa.pl, "pallas_call", split)
    z = jnp.zeros((1, s, 1, D), jnp.bfloat16)
    res = (_bhsd(z), _bhsd(z), _bhsd(z), _bhsd(z),
           jnp.zeros((1, 1, s), jnp.float32), None, None)
    with pytest.raises(_Took) as took:
        jfa._vjp_bwd(True, None, 512, 512, True, False, True, 128, res, z)
    return str(took.value)


@pytest.mark.parametrize("s", [128, 512, 768, 1024])
@pytest.mark.parametrize("env", [
    {}, {"BPS_FLASH_BQ": "256"}, {"BPS_FLASH_FUSED_BWD": "0"},
    {"BPS_FLASH_BQ": "1024", "BPS_FLASH_BK": "1024"}],
    ids=["default", "bq256", "fused_off", "bq_bk_1024"])
def test_backward_route_is_the_jax_packages(s, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tfa.backward_route(s, s) == _jax_route(s, monkeypatch)


def test_gpt2_context_takes_the_split_route():
    assert tfa.resolve_blocks(1024, 1024) == (512, 512)
    assert tfa.backward_route(1024, 1024) == "split"
    assert tfa.backward_route(512, 512) == "fused"


# ---------------------------------------------------- dq / dkv functions

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_split_backward_matches_pallas(dtype, causal):
    """(q, k, v, dO, lse, delta) -> dq and (dk, dv): the port's plain dq
    and dk/dv functions against the Pallas ``_flash_bwd`` (interpret)
    with delta taken from the same bf16/fp32 forward output."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(0, dtype)
    scale = D ** -0.5
    jout, jlse = jfa._flash_fwd(_bhsd(jq), _bhsd(jk), _bhsd(jv), causal,
                                scale, BLK, BLK, True)
    jdq, jdk, jdv, _, _ = jfa._flash_bwd(
        _bhsd(jq), _bhsd(jk), _bhsd(jv), jout, jlse, _bhsd(jdo), causal,
        scale, BLK, BLK, True)
    out = torch.from_numpy(_np(jnp.swapaxes(jout, 1, 2)).copy()).to(tq.dtype)
    lse = torch.from_numpy(_np(jlse[..., 0]).copy())
    delta = tfa.bwd_delta(tdo, out)
    np.testing.assert_allclose(
        delta.numpy(), np.sum(_np(jdo) * _np(jnp.swapaxes(jout, 1, 2)),
                              -1).transpose(0, 2, 1), rtol=1e-5, atol=1e-5)
    n0 = tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches
    dq = tfa.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, causal)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, causal)
    # CPU tensors: the plain versions, no launch counted
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == n0
    for got, ref, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        assert got.dtype == tq.dtype
        _close(got, jnp.swapaxes(ref, 1, 2), dtype, name)


@pytest.mark.parametrize("causal", [False, True])
def test_split_route_autograd_matches_jax_interpret(causal, monkeypatch):
    """The autograd Function on the split route (blocks 128 at s 256)
    against the JAX custom VJP in interpret mode: value and three grads;
    the dq and dk/dv functions each run once, the fused one not at all."""
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(1, "float32")
    calls = []
    for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused"):
        orig = getattr(tfa, name)

        def rec(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(tfa, name, rec)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal, None, BLK, BLK, True)
        return jnp.sum(jnp.sin(o))

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    tval = torch.sin(tfa.flash_attention(tq, tk, tv, causal=causal,
                                         block_q=BLK, block_k=BLK)).sum()
    tval.backward()
    assert calls == ["flash_bwd_dq", "flash_bwd_dkv"]
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5)
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(got.numpy(), _np(ref), err_msg=name,
                                   rtol=2e-4, atol=2e-4)


def test_fused_route_saves_no_output_and_split_route_does():
    """The fused route keeps its "no ``out``" contract; the split route
    saves the forward's output for delta."""
    q = torch.randn(1, 128, 1, D, requires_grad=True)
    fused = tfa.flash_attention(q, q, q)
    split = tfa.flash_attention(q, q, q, block_q=64, block_k=64)
    assert len(fused.grad_fn.saved_tensors) == 4
    assert len(split.grad_fn.saved_tensors) == 5
