"""The port's topk, randomk and dithering compressors held against the JAX
package on the CPU.

The same numpy inputs, made from a seed, go through both. The two sides'
random streams differ (a ``torch.Generator`` against a ``jax.random``
key), so the random compressors are held through their deterministic
cores: randomk's ``compress_with_indices`` with indices from the JAX
package's XorShift128+ (the reference's RNG),
dithering's ``quantize(x, u)`` with the same uniforms; the decorator
chains around them take those draws injected on both sides.

Tolerances, with their reasons:
  - topk and randomk decompressed buffers, dithering
    codes under max normalization: bit for bit (the same selection, the
    same fp32 division, no sum);
  - dithering under L2 normalization: the norm is a sum in another order,
    an ulp or so apart, which moves a code across a level boundary only
    where |x| / scale · s lands within that ulp: at most 1 in 1000 codes
    may differ, and the scale agrees within 1e-6 relative;
  - the error-feedback memory and momentum around each compressor: 1e-5
    relative + 1e-5 absolute, fp32 (XLA may fuse the decorators'
    multiply-adds where PyTorch rounds twice), as in
    ``test_torch_onebit.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops.compression import base as jbase
from byteps_tpu.ops.compression import dithering as jdith
from byteps_tpu.ops.compression import randomk as jrandomk
from byteps_tpu.ops.compression import rng as jrng
from byteps_tpu.ops.compression import topk as jtopk
from byteps_tpu_torch.ops.compression import base, dithering, randomk

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(seed, n):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _decoded(comp, payload):
    return comp.decompress(payload).numpy()


@pytest.mark.parametrize("size", [100, 1000, 4097])
@pytest.mark.parametrize("k", ["0.01", "0.1", "0.5", "5", "37", "5000"])
def test_topk_round_trip_is_the_jax_packages(size, k):
    """decompress(compress(x)) bit for bit, k as a fraction and as a
    count (clipped to the size); the index arrays are not compared (the
    two promise different orders)."""
    kw = {"compressor_type": "topk", "compressor_k": k}
    comp, jcomp = base.create(kw, size), jbase.create(kw, size)
    assert comp.k == jcomp.k
    assert comp.payload_nbytes() == jcomp.payload_nbytes()
    x = _x(size, size)
    pay, _ = comp.compress(torch.from_numpy(x), ())
    jpay, _ = jcomp.compress(jnp.asarray(x), ())
    assert pay["indices"].dtype == torch.int32 and pay["values"].shape == \
        (comp.k,)
    assert np.array_equal(np.sort(pay["indices"].numpy()),
                          np.sort(np.asarray(jpay["indices"])))
    np.testing.assert_array_equal(_decoded(comp, pay),
                                  np.asarray(jcomp.decompress(jpay)))


@pytest.mark.parametrize("size,k", [(1000, 10), (257, 300), (64, 64)])
def test_randomk_with_xorshift_indices_is_the_jax_packages(size, k):
    """``compress_with_indices`` with the reference's RNG drawing k
    indices with replacement (repeats included): payload and
    decompressed buffer bit for bit."""
    comp = randomk.RandomkCompressor(size, k=k, seed=5)
    jcomp = jrandomk.RandomkCompressor(size, k=k, seed=5)
    assert comp.payload_nbytes() == jcomp.payload_nbytes()
    idx = jrng.XorShift128Plus(11).randint_array(0, size, comp.k)
    x = _x(3, size)
    pay, _ = comp.compress_with_indices(torch.from_numpy(x),
                                        torch.from_numpy(idx))
    jpay, _ = jcomp.compress_with_indices(jnp.asarray(x), jnp.asarray(idx))
    np.testing.assert_array_equal(pay["indices"].numpy(),
                                  np.asarray(jpay["indices"]))
    np.testing.assert_array_equal(pay["values"].numpy(),
                                  np.asarray(jpay["values"]))
    np.testing.assert_array_equal(_decoded(comp, pay),
                                  np.asarray(jcomp.decompress(jpay)))


def test_round_next_pow2_in_int64_is_the_jax_uint32_one():
    """Every v in [0, 2^16], the codes of the natural partition up to
    s = 17 (2^(s-1)), and a few up to 2^31."""
    v = np.concatenate([np.arange(0, 2**16 + 1),
                        [2**20 - 1, 2**20 + 1, 2**31 - 1, 2**31]])
    got = dithering.round_next_pow2(torch.from_numpy(v)).numpy()
    want = np.asarray(jdith._round_next_pow2(jnp.asarray(v, jnp.uint32)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("s", [2, 4, 9])
@pytest.mark.parametrize("ntype", [dithering.MAX, dithering.L2])
@pytest.mark.parametrize("ptype", [dithering.LINEAR, dithering.NATURAL])
def test_dithering_quantize_is_the_jax_packages(ptype, ntype, s):
    """``quantize(x, u)`` with the same uniforms: the code type (int16
    past 127: natural s 9), the codes and the scale; decompress within
    fp32 rounding."""
    n = 5000
    comp = dithering.DitheringCompressor(n, s=s, ptype=ptype, ntype=ntype)
    jcomp = jdith.DitheringCompressor(n, s=s, ptype=ptype, ntype=ntype)
    assert comp.qmax == jcomp.qmax
    assert np.dtype(str(comp.qdtype).removeprefix("torch.")) == \
        np.dtype(jcomp.qdtype)
    assert comp.payload_nbytes() == jcomp.payload_nbytes()
    x = _x(20 + s, n) * 3
    u = np.random.RandomState(30 + s).uniform(size=n).astype(np.float32)
    q, scale = comp.quantize(torch.from_numpy(x), torch.from_numpy(u))
    jq, jscale = jcomp.quantize(jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_allclose(scale.item(), float(jscale), rtol=1e-6)
    jq = np.asarray(jq)
    assert q.numpy().dtype == jq.dtype
    differ = np.count_nonzero(q.numpy() != jq)
    if ntype == dithering.MAX:
        assert differ == 0
        assert scale.item() == float(jscale)
    else:
        assert differ <= n // 1000, differ
    np.testing.assert_allclose(
        _decoded(comp, {"q": q, "scale": scale}),
        np.asarray(jcomp.decompress({"q": jnp.asarray(q.numpy()),
                                     "scale": jnp.float32(scale.item())})),
        rtol=1e-6, atol=(differ > 0) * float(jscale) / comp.qmax * 1.01)


def _inject(monkeypatch, draws):
    """Both sides' randomk and dithering draw ``draws[kind][i]`` at their
    i-th compress (a patch of this test, one numpy stream for both)."""
    port, ref = {k: iter(v) for k, v in draws.items()}, \
        {k: iter(v) for k, v in draws.items()}

    def draw(kind):
        def f(self, state, device):
            return torch.from_numpy(next(port[kind])).to(device), state
        return f

    monkeypatch.setattr(randomk.RandomkCompressor, "draw", draw("randomk"))
    monkeypatch.setattr(dithering.DitheringCompressor, "draw",
                        draw("dithering"))
    monkeypatch.setattr(
        jrandomk.RandomkCompressor, "compress",
        lambda self, x, state: (self.compress_with_indices(
            x, jnp.asarray(next(ref["randomk"])))[0], state))

    def jdither(self, x, state):
        q, scale = self.quantize(x, jnp.asarray(next(ref["dithering"])))
        return {"q": q, "scale": scale}, state
    monkeypatch.setattr(jdith.DitheringCompressor, "compress", jdither)


@pytest.mark.parametrize("kind", ["topk", "randomk", "dithering"])
def test_ef_and_nesterov_chain_around_each_compressor(kind, monkeypatch):
    """momentum -> error feedback -> the compressor, two rounds on the
    same inputs: decompressed payloads, error feedback and momentum."""
    n = 3000
    kw = {"compressor_type": kind, "compressor_k": "4" if kind ==
          "dithering" else "0.05", "ef_type": "vanilla",
          "momentum_type": "nesterov", "momentum_mu": "0.8", "seed": "3"}
    comp, jcomp = base.create(kw, n), jbase.create(kw, n)
    assert [type(c).__name__ for c in (comp, comp.inner, comp.inner.inner)] \
        == [type(c).__name__ for c in (jcomp, jcomp.inner,
                                       jcomp.inner.inner)]
    draws = np.random.RandomState(8)
    _inject(monkeypatch, {
        "randomk": [draws.randint(0, n, comp.inner.inner.k).astype(np.int32)
                    if kind == "randomk" else None for _ in range(2)],
        "dithering": [draws.uniform(size=n).astype(np.float32)
                      for _ in range(2)]})
    st, jst = comp.init_state(), jcomp.init_state()
    for r in range(2):
        x = _x(40 + r, n)
        pay, st = comp.compress(torch.from_numpy(x), st)
        jpay, jst = jcomp.compress(jnp.asarray(x), jst)
        np.testing.assert_allclose(_decoded(comp, pay),
                                   np.asarray(jcomp.decompress(jpay)),
                                   err_msg=f"round {r}", **TOL)
        np.testing.assert_allclose(st["m"].numpy(), np.asarray(jst["m"]),
                                   **TOL)
        np.testing.assert_allclose(st["inner"]["error"].numpy(),
                                   np.asarray(jst["inner"]["error"]), **TOL)


@pytest.mark.parametrize("kind", ["randomk", "dithering"])
def test_seeded_draws_repeat_per_seed_and_move_the_state(kind):
    """The same seed gives the same payloads, round after round; another
    seed other ones; each round moves the generator's state (a CPU
    tensor) on."""
    n = 2000
    kw = {"compressor_type": kind, "compressor_k": "0.05"
          if kind == "randomk" else "4"}
    comps = [base.create(dict(kw, seed=str(s)), n) for s in (7, 7, 8)]
    states = [c.init_state() for c in comps]
    x = torch.from_numpy(_x(9, n))
    for _ in range(3):
        outs = []
        for i, c in enumerate(comps):
            before = states[i]["rng"]
            pay, states[i] = c.compress(x, states[i])
            assert states[i]["rng"].device.type == "cpu"
            assert not torch.equal(before, states[i]["rng"])
            outs.append(c.decompress(pay))
        assert torch.equal(outs[0], outs[1])
        assert not torch.equal(outs[0], outs[2])


def test_randomk_indices_lie_in_range_with_replacement():
    comp = randomk.RandomkCompressor(50, k=400, seed=1)
    pay, _ = comp.compress(torch.from_numpy(_x(1, 50)), comp.init_state())
    idx = pay["indices"]
    assert idx.dtype == torch.int32 and idx.shape == (50,)   # k clipped
    assert 0 <= int(idx.min()) and int(idx.max()) < 50
    comp = randomk.RandomkCompressor(1000, k=200, seed=2)
    idx = comp.compress(torch.from_numpy(_x(2, 1000)),
                        comp.init_state())[0]["indices"]
    assert len(set(idx.tolist())) < 200      # drawn with replacement


def test_dithering_is_unbiased():
    """Stochastic rounding is unbiased: the mean of 300 decompressed
    draws lies within 0.05 of x (the JAX package's
    ``test_dithering_unbiased_linear``)."""
    comp = dithering.DitheringCompressor(16, s=4, seed=1)
    x = torch.linspace(-1, 1, 16)
    st = comp.init_state()
    acc = torch.zeros(16, dtype=torch.float64)
    for _ in range(300):
        pay, st = comp.compress(x, st)
        acc += comp.decompress(pay)
    np.testing.assert_allclose((acc / 300).numpy(), x.numpy(), atol=0.05)
