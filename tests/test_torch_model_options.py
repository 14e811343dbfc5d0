"""The port's remat policies held against the JAX package on the CPU:
``dots``, ``mlp_only`` and ``save_attn``, with ``remat_layers`` (the LM
head's options are ``test_torch_lm_head.py``).

Weights cross from JAX by name (``convert.params_from_jax``); batches are
the same seeded numpy arrays. Models are tiny: hidden 64, 2 layers, 4
heads of 16, vocab 128, seq 64, fp32 (``remat=True`` wherever a policy is
set). The JAX side runs its naive attention, the port its flash wrapper,
whose kernels take their plain versions on the CPU.

Tolerances, with their reasons:
  - loss 1e-5 relative, gradients 1e-4 relative + 1e-6 absolute against
    JAX (``test_torch_gpt2.py``'s fp32 parity: the same arithmetic in
    another summation order);
  - every policy against the port's own whole-block remat, fp32 and bf16:
    bit for bit (a policy only chooses which values are kept and which
    recomputed, and the recompute repeats the same ops on the same
    inputs).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_tiny import (WIDTH, assert_grads_match_jax, assert_same_bits,
                         batch, cfgs, cpu_numerics,  # noqa: F401 (fixture)
                         init, jax_loss_grads, port_loss_grads, state)
from byteps_tpu_torch.models import gpt2 as tgpt2
from byteps_tpu_torch.models import transformer as ttr
from byteps_tpu_torch.ops import flash_attention as tfa
from byteps_tpu_torch.parallel import mesh as tmesh

POLICIES = [None, "dots", "mlp_only", "save_attn"]
# (remat options, attention forwards a layer per step)
REMAT = {"remat_none": (dict(remat=True), 2),
         "dots": (dict(remat=True, remat_policy="dots"), 2),
         "mlp_only": (dict(remat=True, remat_policy="mlp_only"), 1),
         "save_attn": (dict(remat=True, remat_policy="save_attn"), 1),
         "no_remat": (dict(remat=False), 1)}
for _p in POLICIES:
    REMAT[f"layers1_{_p}"] = (dict(remat=True, remat_policy=_p,
                                   remat_layers=1), None)
# both models under each policy; GPT-2 under remat_layers
CASES = ([(m, c) for m in ("bert", "gpt2") for c in sorted(REMAT)
          if not c.startswith("layers1")]
         + [("gpt2", c) for c in sorted(REMAT) if c.startswith("layers1")])


@pytest.fixture(autouse=True)
def _numerics(cpu_numerics):
    yield


# ------------------------------------------------------------ remat policies

@pytest.mark.parametrize("model,case", CASES)
def test_remat_options_match_jax_and_whole_block_remat(model, case):
    kw, _ = REMAT[case]
    jcfg, tcfg = cfgs(model, **kw)
    params = init(jcfg)
    data = batch(model)
    jl, jg = jax_loss_grads(model, jcfg, data, params)
    loss, grads = port_loss_grads(model, tcfg, state(params), data)
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
    assert_grads_match_jax(grads, jg)
    _, whole = cfgs(model, remat=True)
    assert_same_bits(loss, grads,
                     *port_loss_grads(model, whole, state(params), data))


@pytest.mark.parametrize("policy", POLICIES[1:])
def test_policies_in_bf16_are_whole_block_remat_bit_for_bit(policy):
    """The casts to the compute dtype sit inside the block: a policy that
    keeps a product keeps the bf16 value the recompute would give."""
    _, tcfg = cfgs("gpt2", dtype="bfloat16", remat=True,
                    remat_policy=policy)
    _, whole = cfgs("gpt2", dtype="bfloat16", remat=True)
    weights = state(init(cfgs("gpt2")[0]))
    data = batch("gpt2", seed=1)
    assert_same_bits(*port_loss_grads("gpt2", tcfg, weights, data),
                     *port_loss_grads("gpt2", whole, weights, data))


def _count_forwards(monkeypatch, tcfg, model="gpt2", mesh=None):
    """Calls of the attention forward (its plain version, what a CPU
    tensor runs) in one forward and backward of ``tcfg``."""
    calls = []
    plain = tfa.flash_fwd_plain

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)

    monkeypatch.setattr(tfa, "flash_fwd_plain", counted)
    m = ttr.Transformer(tcfg)
    data = torch.from_numpy(batch(model))
    if mesh is None:
        tgpt2.causal_lm_loss(m, data).backward()
    else:
        with tmesh.use_mesh(mesh):
            tgpt2.causal_lm_loss(m, data).backward()
    return len(calls)


@pytest.mark.parametrize("case", ["remat_none", "dots", "mlp_only",
                                  "save_attn", "no_remat"])
def test_attention_forwards_per_step(monkeypatch, case):
    """2L under whole-block remat and ``dots`` (the flash forward is no
    dot: recomputed); L under no remat, ``mlp_only`` and ``save_attn``
    (its (out, lse) kept, the kernel not launched again)."""
    kw, per_layer = REMAT[case]
    _, tcfg = cfgs("gpt2", **kw)
    assert _count_forwards(monkeypatch, tcfg) == per_layer * WIDTH["layers"]


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_layers_applies_the_policy_to_the_first_layers(monkeypatch,
                                                             policy):
    """``remat_layers=1``: the first layer under the policy, the second
    with no remat at all (one forward)."""
    _, tcfg = cfgs("gpt2", remat=True, remat_policy=policy, remat_layers=1)
    first = 2 if policy in (None, "dots") else 1
    assert _count_forwards(monkeypatch, tcfg) == first + 1


@pytest.mark.parametrize("policy", ["save_attn", None, "dots"])
def test_save_attn_under_sp_axis_pins_nothing(monkeypatch, policy):
    """Under ``sp_axis`` the ring attention calls its forward past the
    names, as the JAX ring does: ``save_attn`` is whole-block remat there
    (2L forwards of the flash ring on a ring of one), as are None and
    ``dots``."""
    _, tcfg = cfgs("gpt2", remat=True, remat_policy=policy, sp_axis="seq",
                    attn_impl="flash")
    n = _count_forwards(monkeypatch, tcfg, mesh=tmesh.make_mesh({"seq": 1}))
    assert n == 2 * WIDTH["layers"]


@pytest.mark.parametrize("policy", POLICIES)
def test_policies_under_sp_axis_match_jax(policy):
    """A ring of one (the port's flash ring, the JAX naive ring) under
    each policy: the loss and every gradient."""
    jcfg, tcfg = cfgs("gpt2", remat=True, remat_policy=policy,
                       sp_axis="seq", attn_impl="flash")
    jcfg = dataclasses.replace(jcfg, sp_axis=None)  # one device: no axis
    params = init(jcfg)
    data = batch("gpt2", seed=2)
    jl, jg = jax_loss_grads("gpt2", jcfg, data, params)
    with tmesh.use_mesh(tmesh.make_mesh({"seq": 1})):
        loss, grads = port_loss_grads("gpt2", tcfg, state(params), data)
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
    assert_grads_match_jax(grads, jg)


def test_kept_attention_replays_without_launching(monkeypatch):
    """``flash_attention(keep=...)`` (``save_attn``): the first forward
    records (out, lse), a second forward with the same ``keep`` returns
    them, bit for bit, without running the forward; the gradients are
    those of the attention without ``keep``."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 128, 2, 16, generator=g) for _ in range(4))
    calls = []
    plain = tfa.flash_fwd_plain
    monkeypatch.setattr(tfa, "flash_fwd_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    keep, res = {}, []
    for kw in ({}, {"keep": keep}, {"keep": keep}):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = tfa.flash_attention(*xs, causal=True, **kw)
        o.backward(do)
        res.append([o.detach()] + [x.grad for x in xs])
    assert len(calls) == 2 and set(keep) == {"attention"}
    for other in res[1:]:
        for a, b in zip(res[0], other):
            assert torch.equal(a, b)


def test_kept_matmul_replays_and_has_autograds_gradients():
    """``_KeptMatmul`` (``dots``): the first call multiplies and keeps the
    output, the second returns it; both backward passes give autograd's
    gradients of ``x @ w``, bit for bit."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 8, 16, generator=g)
    w = torch.randn(16, 32, generator=g)
    ct = torch.randn(2, 8, 32, generator=g)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    (xa @ wa).backward(ct)
    kept = {}
    for _ in range(2):
        xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = ttr._KeptMatmul.apply(xk, wk, kept, "p")
        y.backward(ct)
        assert torch.equal(y, x @ w) and set(kept) == {"p"}
        assert torch.equal(xk.grad, xa.grad) and torch.equal(wk.grad, wa.grad)
    kept["p"] = torch.zeros_like(kept["p"])     # the second call reads it
    assert torch.equal(ttr._KeptMatmul.apply(x, w, kept, "p"),
                       torch.zeros(2, 8, 32))
