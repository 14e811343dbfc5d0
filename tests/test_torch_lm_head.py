"""The port's LM head held against the JAX package on the CPU: the
chunked head (``lm_head_chunk``), the head's GEMM route and the config's
validation.

Weights cross from JAX by name (``convert.params_from_jax``); batches are
the same seeded numpy arrays, at ``test_torch_model_options.py``'s tiny
width (fp32, remat on).

Tolerances, with their reasons:
  - loss 1e-5 relative, gradients 1e-4 relative + 1e-6 absolute against
    JAX (the same fp32 arithmetic in another summation order; the chunks'
    sums accumulate in chunk order on both sides);
  - the head's GEMM route (``_HeadGemm``, its product emulated here by an
    fp32 product of the rounded operands, exactly what ``aten::mm.dtype``
    computes up to summation order): logits bit for bit the plain route's;
    dh and dE within 1e-2 · max|JAX| (the route rounds the fp32 cotangent
    to bf16 before its GEMMs, one bf16 step, 2^-8 relative, of each
    product; the JAX transpose keeps it in fp32).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tiny import (ROWS, SEQ, WIDTH, assert_grads_match_jax, batch,
                         cfgs, cpu_numerics,  # noqa: F401 (fixture)
                         init, jax_loss_grads, port_loss_grads, state)
from byteps_tpu.models import gpt2 as jgpt2
from byteps_tpu.models import transformer as jtr
from byteps_tpu_torch.models import bert as tbert
from byteps_tpu_torch.models import gpt2 as tgpt2
from byteps_tpu_torch.models import transformer as ttr

POLICIES = [None, "dots", "mlp_only", "save_attn"]


@pytest.fixture(autouse=True)
def _numerics(cpu_numerics):
    yield


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
@pytest.mark.parametrize("model", ["bert", "gpt2"])
def test_chunked_head_matches_jax(model, chunk):
    """``lm_head_chunk`` dividing s (16, 32), equal to it and above it
    (the full head, no warning): the loss and every gradient."""
    jcfg, tcfg = cfgs(model, remat=True, lm_head_chunk=chunk)
    params = init(jcfg)
    data = batch(model, seed=4)
    jl, jg = jax_loss_grads(model, jcfg, data, params)
    loss, grads = port_loss_grads(model, tcfg, state(params), data)
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
    assert_grads_match_jax(grads, jg)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_chunk_not_dividing_seq_warns_once_and_takes_the_full_head(
        monkeypatch):
    monkeypatch.setattr(ttr, "_warned_chunk", set())
    rec = _Records()
    logger = logging.getLogger("byteps_tpu_torch")
    logger.addHandler(rec)
    try:
        jcfg, tcfg = cfgs("gpt2", remat=True, lm_head_chunk=24)
        params = init(jcfg)
        data = batch("gpt2", seed=5)
        jl, jg = jax_loss_grads("gpt2", jcfg, data, params)
        loss, grads = port_loss_grads("gpt2", tcfg, state(params), data)
        again, _ = port_loss_grads("gpt2", tcfg, state(params), data)
    finally:
        logger.removeHandler(rec)
    assert rec.messages == [
        "lm_head_chunk=24 does not divide seq 64 — falling back to the FULL "
        "[s, vocab] head (O(s·vocab) memory); pick a divisor of the "
        "sequence length"]
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
    assert_grads_match_jax(grads, jg)
    _, full = cfgs("gpt2", remat=True)
    full_loss, _ = port_loss_grads("gpt2", full, state(params), data)
    assert loss.item() == again.item() == full_loss.item()


def test_chunked_head_keeps_no_seq_by_vocab_tensor():
    """The forward saves no [b, s, vocab] tensor for the backward: every
    saved tensor of the loss's graph is at most [b, chunk, vocab]."""
    _, tcfg = cfgs("gpt2", remat=False, lm_head_chunk=16,
                    vocab_size=512)
    m = ttr.Transformer(tcfg)
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    data = torch.from_numpy(tgpt2.synth_lm_batch(np.random.RandomState(6),
                                                 ROWS, SEQ, 512))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tgpt2.causal_lm_loss(m, data)
    assert max(sizes) < ROWS * SEQ * 512
    sizes.clear()
    _, full = cfgs("gpt2", remat=False, vocab_size=512)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tgpt2.causal_lm_loss(ttr.Transformer(full), data)
    assert max(sizes) == ROWS * SEQ * 512


def _emulated_mm(a, b, out_dtype):
    """``aten::mm.dtype``'s function on the CPU, which has no kernel for
    it: the (bf16) operands' exact products, summed in fp32."""
    assert out_dtype == torch.float32
    return a.float() @ b.float()


def test_head_gemm_route_against_jax(monkeypatch):
    """``_HeadGemm`` (the card's route) with its GEMM emulated: logits
    bit for bit the plain route's; dh and dE against ``jax.vjp`` of the
    JAX ``logits`` with the same fp32 cotangent."""
    monkeypatch.setattr(ttr.torch, "mm", _emulated_mm)
    rng = np.random.RandomState(7)
    h = rng.randn(2, 32, 64).astype(np.float32)
    emb = (rng.randn(128, 64) * 0.02).astype(np.float32)
    ct = rng.randn(2, 32, 128).astype(np.float32) * 1e-2
    jcfg = jgpt2.gpt2_config(dtype="bfloat16", **WIDTH)
    th = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    temb = torch.from_numpy(emb).requires_grad_()
    lg = ttr._HeadGemm.apply(th, temb, torch.bfloat16)
    assert lg.dtype == torch.float32
    assert torch.equal(lg, ttr.head_logits(th.detach(), temb.detach(),
                                           torch.bfloat16))
    lg.backward(torch.from_numpy(ct))
    jlg, vjp = jax.vjp(
        lambda hh, ee: jtr.logits({"embed": {"tok": ee}}, jcfg, hh),
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(emb))
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(jlg),
                               rtol=0, atol=1e-6)
    jdh, jde = vjp(jnp.asarray(ct))
    for got, ref in ((th.grad, jdh), (temb.grad, jde)):
        ref = np.asarray(ref, np.float32)
        assert got.dtype == (torch.bfloat16 if got is th.grad
                             else torch.float32)
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= 1e-2 * np.abs(ref).max(), err


def test_head_takes_the_plain_route_off_the_card():
    """A CPU tensor never reaches ``aten::mm.dtype`` (no CPU kernel): the
    rounded operands multiplied in fp32."""
    g = torch.Generator().manual_seed(8)
    h = torch.randn(3, 64, generator=g)
    emb = torch.randn(128, 64, generator=g)
    want = (h.to(torch.bfloat16).float()
            @ emb.to(torch.bfloat16).float().t())
    assert torch.equal(ttr.head_logits(h, emb, torch.bfloat16), want)


# ------------------------------------------------------------ validation

@pytest.mark.parametrize("kw", [
    {"remat_policy": "full"},
    {"remat_policy": "dots", "remat": False},
    {"remat_layers": 3},
    {"remat_layers": -2},
    {"remat_layers": 1, "remat": False},
    {"pp_interleave": 0},
    {"pp_interleave": 2},
])
def test_config_errors_are_the_jax_packages_word_for_word(kw):
    base = dict(WIDTH, dtype="float32")
    with pytest.raises(ValueError) as jerr:
        jtr.TransformerConfig(**base, **kw)
    with pytest.raises(ValueError) as terr:
        ttr.TransformerConfig(**base, **kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [{"remat_policy": p} for p in POLICIES[1:]]
                         + [{"lm_head_chunk": 2048}])
def test_ported_options_construct(kw):
    cfg = tbert.bert_large(**kw)
    assert all(getattr(cfg, k) == v for k, v in kw.items())
