"""Shared helpers of the port's model-option tests
(``test_torch_model_options.py``, ``test_torch_lm_head.py``): tiny BERT
and GPT-2 configs on both sides (the JAX side on its naive attention),
their seeded batches, and loss and gradients of one backward on each
side, the port's from the JAX weights (``convert.params_from_jax``)."""

import jax
import numpy as np
import pytest
import torch

from byteps_tpu.models import bert as jbert
from byteps_tpu.models import gpt2 as jgpt2
from byteps_tpu.models import transformer as jtr
from byteps_tpu_torch import convert
from byteps_tpu_torch.models import bert as tbert
from byteps_tpu_torch.models import gpt2 as tgpt2
from byteps_tpu_torch.models import transformer as ttr

WIDTH = dict(hidden=64, layers=2, heads=4, vocab_size=128, max_seq=64)
SEQ, ROWS = 64, 2


@pytest.fixture
def cpu_numerics():
    """Full fp32 matmuls and 2 torch threads (the suite runs in parallel
    workers)."""
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def cfgs(model, dtype="float32", **kw):
    jmod, tmod = (jbert, tbert) if model == "bert" else (jgpt2, tgpt2)
    make = "bert_config" if model == "bert" else "gpt2_config"
    kw = dict(WIDTH, **kw)
    jcfg = getattr(jmod, make)(dtype=dtype, **dict(kw, attn_impl="naive"))
    tcfg = getattr(tmod, make)(dtype=dtype, **kw)
    return jcfg, tcfg


def batch(model, seed=0):
    rng = np.random.RandomState(seed)
    if model == "bert":
        return tbert.synth_mlm_batch(rng, ROWS, SEQ, WIDTH["vocab_size"])
    return tgpt2.synth_lm_batch(rng, ROWS, SEQ, WIDTH["vocab_size"])


def jax_loss_grads(model, jcfg, data, params):
    loss = ((lambda p: jbert.mlm_loss(p, jcfg, data)) if model == "bert"
            else (lambda p: jgpt2.causal_lm_loss(p, jcfg, data)))
    jl, jg = jax.jit(jax.value_and_grad(loss))(params)
    return float(jl), {k: v.numpy() for k, v in convert.params_from_jax(
        jax.tree.map(np.asarray, jg)).items()}


def port_loss_grads(model, tcfg, state, data):
    m = ttr.Transformer(tcfg)
    m.load_state_dict(state)
    if model == "bert":
        loss = tbert.mlm_loss(m, tuple(torch.from_numpy(x) for x in data))
    else:
        loss = tgpt2.causal_lm_loss(m, torch.from_numpy(data))
    loss.backward()
    return loss, {n: p.grad.clone() for n, p in m.named_parameters()}


def init(jcfg):
    return jtr.init_params(jax.random.PRNGKey(0), jcfg)


def state(params):
    return convert.params_from_jax(jax.tree.map(np.asarray, params))


def assert_grads_match_jax(grads, jgrads):
    for name, ref in jgrads.items():
        np.testing.assert_allclose(grads[name].numpy(), ref, rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def assert_same_bits(loss, grads, ref_loss, ref_grads):
    assert loss.item() == ref_loss.item()
    for name, g in grads.items():
        assert torch.equal(g, ref_grads[name]), name
