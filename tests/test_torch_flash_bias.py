"""The port's flash attention with an additive bias or T5's rel table
(``_fwd_kernel`` / ``_dq_kernel`` / ``_dkv_kernel`` in their ``has_bias``
and ``rel`` forms) held against the JAX package on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as ``tests/test_flash_attention.py``
runs them. The same numpy inputs, made from a seed, go through both.
Shapes: b 2, h 2, d 64, s 256 with blocks of 128 each way
(``BPS_FLASH_BQ`` / ``BPS_FLASH_BK`` = 128 where the route reads them), so
the JAX kernels' bucket maps come from block offsets that cross bucket
boundaries; the bias form also at sq 128 against sk 256.

Tolerances, with their reasons (those of ``test_torch_flash_split.py``
for out, lse, dq, dk, dv):
  - fp32: 1e-5 (the same fp32 arithmetic, another summation order);
    autograd grads 2e-4;
  - bf16: max |port - jax| <= 2e-2 · max |jax| (a rounded value may move
    one bf16 step, 2^-8 relative, and the gradients sum many);
  - dbias (dS summed over the batch) and dtable (dS summed over the batch
    and each bucket's positions, up to 2·256·256 terms): max |port - jax|
    <= 1e-4 · max |jax| in fp32 and 2e-2 · max |jax| in bf16. Both are
    fp32 sums of the same dS in another order; dtable's long sums make
    the fp32 bound looser than the elementwise 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops import flash_attention as jfa
from byteps_tpu_torch.ops import flash_attention as tfa
from byteps_tpu_torch.ops import relpos

B, H, D, S, BLK, NB = 2, 2, 64, 256, 128, 32
TOL32 = dict(rtol=1e-5, atol=1e-5)
REL16, REL_GRAD32 = 2e-2, 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (form, causal, sq, sk): the encoder's table, the decoder's, a dense bias
# across unequal lengths, a dense bias under the causal mask
FORMS = [("rel", False, S, S), ("rel", True, S, S), ("bias", False, 128, S),
         ("bias", True, S, S)]
FORM_IDS = ["rel-bidirectional", "rel-causal", "bias-cross", "bias-causal"]


@pytest.fixture(autouse=True)
def _cpu_numerics(monkeypatch):
    """Full fp32 matmuls, 2 torch threads (the suite runs in parallel
    workers), blocks of 128 both ways."""
    monkeypatch.delenv("BPS_FLASH_FUSED_BWD", raising=False)
    monkeypatch.setenv("BPS_FLASH_BQ", str(BLK))
    monkeypatch.setenv("BPS_FLASH_BK", str(BLK))
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _inputs(seed, dtype, sq, sk):
    """q, dO [B, sq, H, D], k, v [B, sk, H, D] rounded once through the
    working type, so both sides see the same values; the table [H, NB] or
    bias [H, sq, sk] in fp32."""
    rng = np.random.RandomState(seed)
    jdt, tdt = DTYPES[dtype]
    shapes = [(B, sq, H, D), (B, sk, H, D), (B, sk, H, D), (B, sq, H, D)]
    torch_in = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(tdt)
                for s in shapes]
    jax_in = [jnp.asarray(t.float().numpy()).astype(jdt) for t in torch_in]
    table = rng.randn(H, NB).astype(np.float32)
    bias = rng.randn(H, sq, sk).astype(np.float32)
    return jax_in, torch_in, table, bias


def _bhsd(x):                 # [b, s, h, d] jax -> [b, h, s, d]
    return jnp.swapaxes(x, 1, 2)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got: torch.Tensor, ref, dtype, name, rel32=None):
    ref = _np(ref)
    got = got.detach().float().numpy()
    if dtype == "float32" and rel32 is None:
        np.testing.assert_allclose(got, ref, err_msg=name, **TOL32)
        return
    bound = (rel32 if dtype == "float32" else REL16) * np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= bound, f"{name}: max err {err} > {bound}"


def _jax_form_kw(form, causal, table, bias):
    if form == "rel":
        return {"rel_table": jnp.asarray(table),
                "rel": (not causal, NB, 128)}
    return {"bias": jnp.asarray(bias)}


def _port_form_kw(form, causal, table, bias):
    if form == "rel":
        return {"rel_table": torch.from_numpy(table),
                "rel_bidirectional": not causal, "rel_max_distance": 128}
    return {"bias": torch.from_numpy(bias)}


# ------------------------------------------------------------ functions

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form,causal,sq,sk", FORMS, ids=FORM_IDS)
def test_plain_forms_match_pallas(form, causal, sq, sk, dtype):
    """Forward (out, lse), dq with dbias or dtable, and dk/dv of each form:
    the port's plain versions against the Pallas ``_flash_fwd`` and
    ``_flash_bwd`` (interpret), delta from the same forward output."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), table, bias = _inputs(
        0, dtype, sq, sk)
    # d^-0.5 keeps unit-normal scores: at T5's 1.0 (the autograd test
    # below) they have std 8, and near-zero gradients cancel past 1e-5
    scale = D ** -0.5
    jkw = _jax_form_kw(form, causal, table, bias)
    tkw = _port_form_kw(form, causal, table, bias)
    jout, jlse = jfa._flash_fwd(_bhsd(jq), _bhsd(jk), _bhsd(jv), causal,
                                scale, BLK, BLK, True, **jkw)
    jdq, jdk, jdv, jdbias, jdrel = jfa._flash_bwd(
        _bhsd(jq), _bhsd(jk), _bhsd(jv), jout, jlse, _bhsd(jdo), causal,
        scale, BLK, BLK, True, **jkw)
    out, lse = tfa.flash_fwd(tq, tk, tv, causal, scale, **tkw)
    _close(out, jnp.swapaxes(jout, 1, 2), dtype, "out")
    np.testing.assert_allclose(lse.numpy(), _np(jlse[..., 0]), rtol=1e-5,
                               atol=1e-5 if dtype == "float32" else 1e-3)
    # the backward from the JAX forward's outputs, as the split route reads
    jo = torch.from_numpy(_np(jnp.swapaxes(jout, 1, 2)).copy()).to(tq.dtype)
    jl = torch.from_numpy(_np(jlse[..., 0]).copy())
    delta = tfa.bwd_delta(tdo, jo)
    dq, dgrad = tfa.flash_bwd_dq(tq, tk, tv, tdo, jl, delta, causal, scale,
                                 **tkw)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tdo, jl, delta, causal, scale,
                               **tkw)
    for got, ref, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        assert got.dtype == tq.dtype
        _close(got, jnp.swapaxes(ref, 1, 2), dtype, name)
    ref_grad = jdrel if form == "rel" else jdbias
    assert dgrad.dtype == torch.float32
    assert tuple(dgrad.shape) == tuple(ref_grad.shape)
    _close(dgrad, ref_grad, dtype, "dtable" if form == "rel" else "dbias",
           rel32=REL_GRAD32)


def test_dense_bias_of_the_table_is_the_table_form():
    """Given the materialized ``relative_bias`` of the same table, the
    dense form computes the table form's values (the kernels add the same
    fp32 addend), and dbias summed by bucket is dtable."""
    (_, _, _, _), (q, k, v, do), table, _ = _inputs(1, "float32", S, S)
    t = torch.from_numpy(table)
    dense = relpos.relative_bias(t.T, S, S, True)
    out_t, lse_t = tfa.flash_fwd(q, k, v, scale=1.0, rel_table=t)
    out_d, lse_d = tfa.flash_fwd(q, k, v, scale=1.0, bias=dense)
    assert torch.equal(out_t, out_d) and torch.equal(lse_t, lse_d)
    delta = tfa.bwd_delta(do, out_t)
    dq_t, dtable = tfa.flash_bwd_dq(q, k, v, do, lse_t, delta, scale=1.0,
                                    rel_table=t)
    dq_d, dbias = tfa.flash_bwd_dq(q, k, v, do, lse_t, delta, scale=1.0,
                                   bias=dense)
    assert torch.equal(dq_t, dq_d)
    bucket = relpos.bucket_map(S, S, True)
    by_bucket = torch.zeros(H, NB, dtype=torch.float64).index_add_(
        1, bucket.reshape(-1), dbias.double().reshape(H, -1))
    np.testing.assert_allclose(dtable.numpy(), by_bucket.numpy(),
                               rtol=1e-4, atol=1e-6)


# -------------------------------------------------------------- autograd

@pytest.mark.parametrize("form,causal,sq,sk", FORMS, ids=FORM_IDS)
def test_autograd_matches_jax_vjp_interpret(form, causal, sq, sk):
    """``flash_attention(rel_table=…)`` / ``(bias=…)`` through autograd
    against ``jax.vjp`` of the JAX ``flash_attention(..., interpret=True)``:
    the value, dq, dk, dv and the gradient of the table or the bias."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), table, bias = _inputs(
        2, "float32", sq, sk)
    scale = 1.0 if form == "rel" else None
    extra_np = table if form == "rel" else bias

    def jfn(q, k, v, extra):
        kw = ({"rel_table": extra, "rel_bidirectional": not causal}
              if form == "rel" else {"bias": extra})
        return jfa.flash_attention(q, k, v, causal, scale, 512, 512, True,
                                   **kw)

    jout, vjp = jax.vjp(jfn, jq, jk, jv, jnp.asarray(extra_np))
    jgrads = vjp(jdo)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    extra = torch.from_numpy(extra_np).requires_grad_()
    kw = ({"rel_table": extra, "rel_bidirectional": not causal}
          if form == "rel" else {"bias": extra})
    out = tfa.flash_attention(*leaves, causal=causal, scale=scale, **kw)
    out.backward(tdo)
    np.testing.assert_allclose(out.detach().numpy(), _np(jout), **TOL32)
    for got, ref, name in zip((*leaves, extra), jgrads,
                              ("dq", "dk", "dv", "d" + form)):
        np.testing.assert_allclose(got.grad.numpy(), _np(ref), err_msg=name,
                                   rtol=2e-4, atol=2e-4)


def test_biased_calls_take_the_split_route_at_one_block(monkeypatch):
    """As ``_flash_bwd`` does: a bias or table never takes the fused
    kernel, even when the whole sequence is one block."""
    monkeypatch.delenv("BPS_FLASH_BQ")
    monkeypatch.delenv("BPS_FLASH_BK")
    assert tfa.backward_route(512, 512) == "fused"
    assert tfa.backward_route(512, 512, biased=True) == "split"
    calls = []
    for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused"):
        orig = getattr(tfa, name)

        def rec(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(tfa, name, rec)
    q = torch.randn(1, 128, 2, D, requires_grad=True)
    tfa.flash_attention(q, q, q, rel_table=torch.zeros(2, NB)).sum().backward()
    assert calls == ["flash_bwd_dq", "flash_bwd_dkv"]


@pytest.mark.parametrize("causal", [False, True])
def test_naive_impl_materializes_the_table_as_the_jax_package(causal):
    """``attention(impl="naive", rel_table=…)``: the plain O(s²) oracle
    with the table materialized through ``relative_bias``, against the
    JAX dispatcher's naive route."""
    (jq, jk, jv, _), (tq, tk, tv, _), table, _ = _inputs(3, "float32", S, S)
    kw = dict(causal=causal, scale=1.0, impl="naive",
              rel_bidirectional=not causal)
    want = jfa.attention(jq, jk, jv, rel_table=jnp.asarray(table), **kw)
    got = tfa.attention(tq, tk, tv, rel_table=torch.from_numpy(table), **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL32)
    flash = tfa.attention(tq, tk, tv, rel_table=torch.from_numpy(table),
                          **dict(kw, impl="auto"))
    np.testing.assert_allclose(flash.numpy(), got.numpy(), **TOL32)
