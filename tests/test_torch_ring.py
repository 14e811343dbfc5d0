"""The port's ring attention and the two kernel forms only the ring
reaches, held against the JAX package on the CPU, in one process.

  - form 1f: the forward's fp32 ``out_dtype`` (``flash_fwd_plain``, what
    the CUDA kernel computes) against the Pallas ``_flash_fwd(...,
    out_dtype=float32)`` in interpret mode;
  - form 2d: the fused backward with ``delta`` given against the Pallas
    ``_flash_bwd_fused(..., delta)`` in interpret mode, and against the
    split route (dq, then dk/dv) with the same delta, bit for bit;
  - the ring at sp 1 (a ``{"seq": 1}`` mesh) against the JAX
    ``ring_attention`` on a one-device ``seq`` mesh (flash ring,
    interpret mode): output and gradients, causal and full, fp32 and
    bf16;
  - ``ring_schedule``, the flash ring's schedule of all sp ranks in one
    process (what ``chip_smoke.py`` runs on the card), at sp 4 against
    single-device attention and its autograd.

Seeded numpy inputs. Tolerances, with their reasons:
  - fp32: 1e-5 (the same fp32 arithmetic in another summation order);
  - bf16 inputs, fp32 forward out: 1e-2 · max|ref| (P is rounded to bf16
    before P·V on both sides; an exp one ulp apart can round P to the
    neighbouring bf16 value);
  - the ring at sp 1 in bf16: 2e-2 · max|ref| for out and gradients (the
    gradients come back in bf16 from bf16 dS);
  - the schedule: 1e-5 out, 1e-4 gradients (fp32; the ring sums each
    gradient block by block).
The multi-rank ring over gloo is ``test_torch_ring_gloo.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from byteps_tpu.ops import flash_attention as jfa
from byteps_tpu.parallel import ring as jring
from byteps_tpu_torch.ops import flash_attention as tfa
from byteps_tpu_torch.parallel import ring as tring
from byteps_tpu_torch.parallel.mesh import make_mesh, use_mesh

TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _cpu_numerics():
    """Full fp32 matmuls and 2 torch threads (the suite runs in parallel
    workers), whatever an earlier test in this worker set."""
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _arrays(seed, shape, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _bhsd(x, dtype=jnp.float32):          # [b, s, h, d] -> [b, h, s, d]
    return jnp.asarray(np.swapaxes(x, 1, 2), dtype)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_rel(got, ref, rel, name):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (name, err, np.abs(ref).max())


# ------------------------------------------------------------- form 1f

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_fp32_out_forward_matches_pallas(causal, dtype):
    """One 256-block per (batch, head): out in fp32 and lse."""
    tdt, jdt = DTYPES[dtype]
    b, s, h, d = 2, 256, 2, 32
    q, k, v, _ = _arrays(0, (b, s, h, d))
    scale = d ** -0.5
    jout, jlse = jfa._flash_fwd(_bhsd(q, jdt), _bhsd(k, jdt), _bhsd(v, jdt),
                                causal, scale, s, s, True,
                                out_dtype=jnp.float32)
    assert jout.dtype == jnp.float32
    tq, tk, tv = (_t(x, tdt) for x in (q, k, v))
    before = (tfa.flash_fwd.launches, tfa.flash_fwd.launches_f32)
    out, lse = tfa.flash_fwd(tq, tk, tv, causal, out_dtype=torch.float32)
    assert (tfa.flash_fwd.launches, tfa.flash_fwd.launches_f32) == before
    assert out.dtype == torch.float32 and out.shape == (b, s, h, d)
    ref = np.swapaxes(np.asarray(jout), 1, 2)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
    else:
        _close_rel(out.numpy(), ref, 1e-2, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=1e-5, atol=1e-5)
    # the fp32 out rounded to q's dtype is the default launch's out
    out16, lse16 = tfa.flash_fwd(tq, tk, tv, causal)
    assert torch.equal(out.to(tdt), out16) and torch.equal(lse, lse16)


def test_out_dtype_contract():
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="out_dtype"):
        tfa.flash_fwd(q, q, q, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="no-bias"):
        tfa.flash_fwd(q, q, q, bias=torch.zeros(2, 64, 64),
                      out_dtype=torch.float32)
    with pytest.raises(ValueError, match="delta"):    # the CUDA branch's check
        tfa._check_bwd_inputs(q, q, q, q, torch.zeros(1, 2, 64),
                              torch.zeros(1, 2, 64, dtype=torch.float16))
    for fn, variant in ((tfa.flash_fwd, "f32"),
                        (tfa.flash_bwd_fused, "delta")):
        setattr(fn, f"launches_{variant}", 7)       # a stale count
        tfa.zero_counts(fn)
        assert getattr(fn, f"launches_{variant}") == 0
        assert getattr(fn, f"launches_{variant}_d") == {64: 0, 128: 0}
        tfa._count(fn, tfa.FORM_NONE, 128, variant)
        assert (fn.launches, getattr(fn, f"launches_{variant}")) == (1, 1)
        assert getattr(fn, f"launches_{variant}_d") == {64: 0, 128: 1}
        tfa.zero_counts(fn)


# ------------------------------------------------------------- form 2d

@pytest.mark.parametrize("causal", [False, True])
def test_fused_backward_with_delta_matches_pallas(causal):
    """delta = rowsum(dO∘out) given to both, fp32, one 128-block."""
    b, s, h, d = 2, 128, 2, 32
    q, k, v, do = _arrays(1, (b, s, h, d))
    # a delta that is not the block's own rowsum(P∘dP), as the ring's
    # global delta is not
    delta = np.random.RandomState(2).randn(b, h, s).astype(np.float32)
    scale = d ** -0.5
    _, jlse = jfa._flash_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale,
                             s, s, True)
    jd = jfa._flash_bwd_fused(_bhsd(q), _bhsd(k), _bhsd(v), jlse, _bhsd(do),
                              jnp.asarray(delta)[..., None], causal, scale,
                              s, s, True, 1)
    lse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    args = [_t(x) for x in (q, k, v, do)] + [lse]
    before = (tfa.flash_bwd_fused.launches,
              tfa.flash_bwd_fused.launches_delta)
    got = tfa.flash_bwd_fused(*args, causal, delta=_t(delta))
    assert (tfa.flash_bwd_fused.launches,
            tfa.flash_bwd_fused.launches_delta) == before
    for g, r, name in zip(got, jd, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(r), 1, 2),
                                   err_msg=name, **TOL)
    # the split route with the same delta: the same function, bit for bit
    split = (tfa.flash_bwd_dq(*args, _t(delta), causal),
             *tfa.flash_bwd_dkv(*args, _t(delta), causal))
    for g, r in zip(got, split):
        assert torch.equal(g, r)


# ----------------------------------------------------------- ring, sp 1

@functools.lru_cache(maxsize=None)
def _jax_ring_sp1(causal, dtype, seed):
    """The JAX flash ring (interpret) on a one-device ``seq`` mesh: out
    and the gradients of sum(o · (o + 1))."""
    jdt = DTYPES[dtype][1]
    q, k, v = (jnp.asarray(x, jdt) for x in _arrays(seed, (2, 256, 2, 16), 3))
    mesh = JMesh(np.asarray(jax.devices()[:1]).reshape(1), ("seq",))
    spec = P(None, "seq")

    def f(q, k, v):
        def loss(q, k, v):
            o = jring.ring_attention(q, k, v, "seq", causal=causal,
                                     impl="flash", interpret=True)
            return (o.astype(jnp.float32) * (o.astype(jnp.float32) + 1.0)
                    ).sum(), o
        (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
        return o, g

    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=spec,
                               out_specs=(spec, spec), check_vma=False))
    sh = NamedSharding(mesh, spec)
    o, g = fn(*(jax.device_put(x, sh) for x in (q, k, v)))
    return _np(o), tuple(_np(x) for x in g)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_ring_sp1_matches_jax_flash_ring(impl, causal, dtype):
    tdt = DTYPES[dtype][0]
    jo, jg = _jax_ring_sp1(causal, dtype, 3)
    xs = [_t(x, tdt).requires_grad_()
          for x in _arrays(3, (2, 256, 2, 16), 3)]
    with use_mesh(make_mesh({"seq": 1})):
        o = tring.ring_attention(*xs, "seq", causal=causal, impl=impl)
    assert o.dtype == tdt
    (o.float() * (o.float() + 1.0)).sum().backward()
    if dtype == "float32":
        np.testing.assert_allclose(o.detach().numpy(), jo, **TOL)
        for x, r, name in zip(xs, jg, "qkv"):
            np.testing.assert_allclose(x.grad.numpy(), r, err_msg=name,
                                       rtol=1e-5, atol=1e-4)
    else:
        _close_rel(o.detach().float().numpy(), jo, 2e-2, "out")
        for x, r, name in zip(xs, jg, "qkv"):
            _close_rel(x.grad.float().numpy(), r, 2e-2, f"d{name}")


def test_ring_without_mesh_or_axis_raises():
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(RuntimeError, match="no mesh is current"):
        tring.ring_attention(q, q, q, "seq")
    with use_mesh(make_mesh({"data": 1})):
        with pytest.raises(ValueError, match="no 'seq' axis"):
            tring.ring_attention(q, q, q, "seq")
    with use_mesh(make_mesh({"seq": 1})):
        with pytest.raises(ValueError, match="impl"):
            tring.ring_attention(q, q, q, "seq", impl="hybrid")
        with pytest.raises(ValueError, match="shards must agree"):
            tring.ring_attention(q, q[:, :32], q[:, :32], "seq")


# ------------------------------------------------------------ schedule

@pytest.mark.parametrize("causal", [False, True])
def test_ring_schedule_sp4_matches_full_attention(causal):
    """All four ranks' blocks in the ring's order (diagonal, visible and,
    causally, hidden blocks) against attention over the whole sequence
    and its autograd. Shards of 128 take the fused backward with delta
    given; the same schedule at shards of 1024 (two blocks) would take
    the split route."""
    q, k, v, do = (_t(x) for x in _arrays(4, (1, 512, 2, 16)))
    out, lse, dq, dk, dv = tring.ring_schedule(q, k, v, do, 4, causal)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = tring.local_attention(*xs, causal=causal)
    ref.backward(do)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), **TOL)
    _, want_lse = tfa.flash_fwd_plain(q, k, v, causal)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **TOL)
    for got, x, name in zip((dq, dk, dv), xs, "qkv"):
        np.testing.assert_allclose(got.numpy(), x.grad.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert tring.blk_route(128) == "fused" and tring.blk_route(1024) == "split"


def test_combine_against_the_start_returns_the_block():
    """(0, -1e30) merged with a block's partial: the block, bit for bit,
    no NaN (exp(-1e30 - lse) underflows to 0)."""
    o_b = torch.randn(2, 64, 2, 16)
    lse_b = torch.randn(2, 2, 64) * 30
    o, lse = tring.combine(torch.zeros_like(o_b),
                           torch.full_like(lse_b, -1e30), o_b, lse_b)
    assert torch.equal(o, o_b) and torch.equal(lse, lse_b)
