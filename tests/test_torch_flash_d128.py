"""The port's flash attention at head dim 128, held against the JAX
package on the CPU, and BERT at d 128 through both trainers.

At d 128 (BERT-large's dh128 variant, ``bench.py``: 8 heads of 128) the
Hopper kernels are a second instantiation of the same sources; on the CPU
the port's wrappers take their plain PyTorch versions, the function those
kernels compute, and the JAX kernels run in Pallas interpret mode, as
``tests/test_flash_attention.py`` runs them. The same numpy inputs, made
from a seed, go through both. Shapes: b 2, h 2, d 128, fp32; s 128 (one
block: the fused backward) and s 256 with blocks of 128 each way (the
split backward, and the bias and table forms).

Tolerances, with their reasons:
  - out, lse, dq, dk, dv: 1e-5 (the same fp32 arithmetic, another
    summation order), as in the d-64 files;
  - dbias (dS summed over the batch) and dtable (dS summed over the batch
    and each bucket's positions, up to 2·256·256 terms): max |port - jax|
    <= 1e-5 · max |jax|. Both are fp32 sums of the same dS in another
    order; elementwise, a long sum that cancels to near 0 would miss an
    absolute 1e-5, so the bound is relative to the largest entry;
  - the trainers, as ``test_torch_bert.py``: loss 1e-5 relative, params
    after 3 AdamW steps 1e-5 absolute, eps 1e-6 on both sides.

The kernels themselves are checked at d 128 on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.models import bert as jbert
from byteps_tpu.models import transformer as jtr
from byteps_tpu.ops import flash_attention as jfa
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu.training import DistributedTrainer as JaxTrainer
from byteps_tpu_torch import convert
from byteps_tpu_torch.models import bert as tbert
from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops import flash_attention as tfa
from byteps_tpu_torch.optim import adamw
from byteps_tpu_torch.training import DistributedTrainer

B, H, D, BLK, NB = 2, 2, 128, 128, 32
TOL = dict(rtol=1e-5, atol=1e-5)
REL_GRAD = 1e-5
# BERT at d 128: hidden 256 over 2 heads, 2 layers
WIDTH = dict(hidden=256, layers=2, heads=2, vocab_size=128, max_seq=128)
SEQ, MAX_PRED, LR, EPS = 128, 25, 1e-3, 1e-6

_PORT_ENV = ("BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_NUM_WORKER",
             "DMLC_NUM_WORKER", "BPS_ENABLE_PS", "BYTEPS_ENABLE_PS",
             "BPS_ENABLE_ASYNC", "BYTEPS_ENABLE_ASYNC", "BPS_PP_STAGES",
             "BPS_FLASH_BQ", "BPS_FLASH_BK", "BPS_FLASH_FUSED_BWD")


@pytest.fixture(autouse=True)
def _cpu_numerics(monkeypatch):
    """Full fp32 matmuls, 2 torch threads (the suite runs in parallel
    workers), and none of the port's or the route's env knobs set."""
    for name in _PORT_ENV:
        monkeypatch.delenv(name, raising=False)
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _inputs(seed, sq, sk=None):
    """q, dO [B, sq, H, D] and k, v [B, sk, H, D] fp32; a table [H, NB] and
    a bias [H, sq, sk]."""
    rng = np.random.RandomState(seed)
    sk = sq if sk is None else sk
    q, k, v, do = (rng.randn(B, s, H, D).astype(np.float32)
                   for s in (sq, sk, sk, sq))
    return q, k, v, do, rng.randn(H, NB).astype(np.float32), \
        rng.randn(H, sq, sk).astype(np.float32)


def _bhsd(x):                 # [b, s, h, d] numpy -> [b, h, s, d] jax
    return jnp.asarray(np.swapaxes(x, 1, 2))


def _bshd(x):                 # [b, h, s, d] jax -> [b, s, h, d] numpy
    return np.swapaxes(np.asarray(x), 1, 2)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close_rel(got, ref, name):
    ref = np.asarray(ref)
    err = np.abs(got.numpy() - ref).max()
    assert err <= REL_GRAD * np.abs(ref).max(), f"{name}: max err {err}"


# ------------------------------------------------------- the kernels' functions

@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_at_d128_matches_pallas(s, causal):
    q, k, v, _, _, _ = _inputs(0, s)
    scale = D ** -0.5
    jout, jlse = jfa._flash_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale,
                                BLK, BLK, True)
    before = dict(tfa.flash_fwd.launches_d)
    out, lse = tfa.flash_fwd(_t(q), _t(k), _t(v), causal)
    assert tfa.flash_fwd.launches_d == before     # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), _bshd(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_backward_at_d128_matches_pallas(causal):
    """One block per (batch, head): (q, k, v, dO, lse) -> (dq, dk, dv),
    delta from P∘dP on both sides."""
    s = 128
    q, k, v, do, _, _ = _inputs(1, s)
    scale = D ** -0.5
    _, jlse = jfa._flash_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale,
                             s, s, True)
    jgrads = jfa._flash_bwd_fused(_bhsd(q), _bhsd(k), _bhsd(v), jlse,
                                  _bhsd(do), None, causal, scale, s, s, True,
                                  1)
    lse = _t(np.asarray(jlse)[..., 0])
    got = tfa.flash_bwd_fused(_t(q), _t(k), _t(v), _t(do), lse, causal)
    for g, ref, name in zip(got, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), _bshd(ref), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_split_backward_at_d128_matches_pallas(causal):
    """s 256 in blocks of 128: ``_flash_bwd``'s split dq and dk/dv with
    delta from the same forward output."""
    s = 256
    q, k, v, do, _, _ = _inputs(2, s)
    scale = D ** -0.5
    jout, jlse = jfa._flash_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale,
                                BLK, BLK, True)
    jdq, jdk, jdv, _, _ = jfa._flash_bwd(
        _bhsd(q), _bhsd(k), _bhsd(v), jout, jlse, _bhsd(do), causal, scale,
        BLK, BLK, True)
    lse = _t(np.asarray(jlse)[..., 0])
    delta = tfa.bwd_delta(_t(do), _t(_bshd(jout)))
    dq = tfa.flash_bwd_dq(_t(q), _t(k), _t(v), _t(do), lse, delta, causal)
    dk, dv = tfa.flash_bwd_dkv(_t(q), _t(k), _t(v), _t(do), lse, delta,
                               causal)
    for g, ref, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        np.testing.assert_allclose(g.numpy(), _bshd(ref), err_msg=name,
                                   **TOL)


# (form, causal, sq, sk): the table both ways, a dense bias across unequal
# lengths and under the causal mask
FORMS = [("rel", False, 256, 256), ("rel", True, 256, 256),
         ("bias", False, 128, 256), ("bias", True, 256, 256)]


@pytest.mark.parametrize("form,causal,sq,sk", FORMS,
                         ids=["rel-bidirectional", "rel-causal", "bias-cross",
                              "bias-causal"])
def test_bias_forms_at_d128_match_pallas(form, causal, sq, sk):
    """Forward, dq with dtable or dbias, and dk/dv of each form against the
    Pallas ``_flash_fwd`` and ``_flash_bwd`` (interpret), blocks of 128."""
    q, k, v, do, table, bias = _inputs(3, sq, sk)
    scale = D ** -0.5
    if form == "rel":
        jkw = {"rel_table": jnp.asarray(table), "rel": (not causal, NB, 128)}
        tkw = {"rel_table": _t(table), "rel_bidirectional": not causal,
               "rel_max_distance": 128}
    else:
        jkw, tkw = {"bias": jnp.asarray(bias)}, {"bias": _t(bias)}
    jout, jlse = jfa._flash_fwd(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale,
                                BLK, BLK, True, **jkw)
    jdq, jdk, jdv, jdbias, jdrel = jfa._flash_bwd(
        _bhsd(q), _bhsd(k), _bhsd(v), jout, jlse, _bhsd(do), causal, scale,
        BLK, BLK, True, **jkw)
    out, lse = tfa.flash_fwd(_t(q), _t(k), _t(v), causal, scale, **tkw)
    np.testing.assert_allclose(out.numpy(), _bshd(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], **TOL)
    jl = _t(np.asarray(jlse)[..., 0])
    delta = tfa.bwd_delta(_t(do), _t(_bshd(jout)))
    dq, dgrad = tfa.flash_bwd_dq(_t(q), _t(k), _t(v), _t(do), jl, delta,
                                 causal, scale, **tkw)
    dk, dv = tfa.flash_bwd_dkv(_t(q), _t(k), _t(v), _t(do), jl, delta,
                               causal, scale, **tkw)
    for g, ref, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        np.testing.assert_allclose(g.numpy(), _bshd(ref), err_msg=name,
                                   **TOL)
    ref = jdrel if form == "rel" else jdbias
    assert tuple(dgrad.shape) == tuple(ref.shape)
    _close_rel(dgrad, ref, "dtable" if form == "rel" else "dbias")


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_at_d128_matches_jax_interpret(causal):
    """The autograd Function end to end on the fused route (s 128, one
    block) against the JAX custom VJP in interpret mode."""
    s = 128
    q, k, v, _, _, _ = _inputs(4, s)

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jfa.flash_attention(q, k, v, causal, None, s,
                                                   s, True)))

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    tval = torch.sin(tfa.attention(*leaves, causal=causal)).sum()
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5)
    for got, ref, name in zip(leaves, jgrads, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   err_msg=name, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------- the wrappers

_COUNTS = ("launches", "launches_bias", "launches_rel", "launches_d",
           "launches_bias_d", "launches_rel_d")


def test_counters_keep_one_count_per_width():
    for fn in (tfa.flash_fwd, tfa.flash_bwd_fused, tfa.flash_bwd_dq,
               tfa.flash_bwd_dkv):
        for name in ("launches_d", "launches_bias_d", "launches_rel_d"):
            assert set(getattr(fn, name)) == set(tfa.KERNEL_DS) == {64, 128}
    fn = tfa.flash_fwd
    saved = {name: getattr(fn, name) for name in _COUNTS}
    try:
        tfa.zero_counts(fn)
        tfa._count(fn, tfa.FORM_REL, 128)
        tfa._count(fn, tfa.FORM_BIAS, 64)
        tfa._count(fn, tfa.FORM_NONE, 128)
        assert (fn.launches, fn.launches_bias, fn.launches_rel) == (3, 1, 1)
        assert fn.launches_d == {64: 1, 128: 2}
        assert fn.launches_bias_d == {64: 1, 128: 0}
        assert fn.launches_rel_d == {64: 0, 128: 1}
        tfa.zero_counts(fn)
        assert fn.launches == fn.launches_bias == fn.launches_rel == 0
        for name in ("launches_d", "launches_bias_d", "launches_rel_d"):
            assert getattr(fn, name) == {64: 0, 128: 0}
    finally:
        for name, value in saved.items():
            setattr(fn, name, value)


# two entries of an nvcc -Xptxas -v log as the H100's toolchain writes
# them: a kernel in an anonymous namespace carries a per-file prefix
_DKV = ("_ZN45_GLOBAL__N__ef5963ac_12_flash_bwd_cu_39da42f620flash_bwd_dkv_"
        "kernelILi128ELi0EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16"
        "S5_iii11BshdStridesfi8BiasArgs")
_DQ = ("_ZN45_GLOBAL__N__ef5963ac_12_flash_bwd_cu_39da42f619flash_bwd_dq_"
       "kernelILb0ELi128ELi0EEEv14CUtensorMap_stS1_S1_S1_PKfPfP13__nv_"
       "bfloat16iii11BshdStridesfi8BiasArgsS3_")


def _ptxas_log(dq_spills=False):
    """nvcc's -Xptxas -v output for the fused backward's two kernels at
    d 128 (their mangled names as nvcc writes them), the dq kernel with a
    spill when asked."""
    dq_frame = ("8 bytes stack frame, 4 bytes spill stores, 12 bytes spill "
                "loads" if dq_spills else
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                "loads")
    return (
        "ptxas info    : 0 bytes gmem\n"
        f"ptxas info    : Compiling entry function '{_DKV}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {_DKV}\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 230 registers, used 1 barriers, 928 bytes cmem[0]\n"
        f"ptxas info    : Compiling entry function '{_DQ}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {_DQ}\n"
        f"    {dq_frame}\n"
        "ptxas info    : Used 156 registers, used 1 barriers, 936 bytes cmem[0]\n")


def _sass_listing():
    """cuobjdump -sass of the same library: each kernel's wgmma products,
    TMA tensor loads and (dk/dv) bulk copies of lse and delta."""
    def fn(name, ops):
        body = "".join(f"        /*{i:04x}*/                   {op} ;\n"
                       for i, op in enumerate(ops))
        return f"\t\tFunction : {name}\n{body}"
    return ("\tcode for sm_90a\n"
            + fn(_DKV, ["UTMALDG.4D [UR8], [UR4]"] * 8
                 + ["UBLKCP.S.G [UR4], [UR6], UR5"] * 2
                 + ["HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT"] * 32
                 + ["EXIT"])
            + fn(_DQ, ["UTMALDG.4D [UR8], [UR4]"] * 8
                 + ["HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT"] * 40
                 + ["EXIT"]))


def _keep_logs(tmp_path, monkeypatch, logs, sass=None):
    """A build directory holding only the ptxas logs ``logs`` ({source:
    nvcc output}) and SASS listings ``sass`` ({source: cuobjdump output})
    beside where their libraries would be: what a cached build leaves for
    a process that compiles nothing."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    for stem in _build.SIGNATURES:
        _build._log_path(stem).write_text(logs.get(stem, ""))
        _build._sass_path(stem).write_text((sass or {}).get(stem, ""))


def test_ptxas_report_reads_each_instantiation(tmp_path, monkeypatch):
    """The report that chip_smoke prints: one row per kernel template
    instance, with its template arguments (here the head dim 128), read
    from the log kept beside the library, spills included."""
    _keep_logs(tmp_path, monkeypatch, {"flash_bwd": _ptxas_log(True)})
    rows = _build.ptxas_report(["flash_bwd", "flash_fwd"])
    assert rows == [
        {"source": "flash_bwd", "kernel": "flash_bwd_dkv_kernel",
         "args": [128, 0], "registers": 230, "stack": 0,
         "spill_stores": 0, "spill_loads": 0},
        {"source": "flash_bwd", "kernel": "flash_bwd_dq_kernel",
         "args": [0, 128, 0], "registers": 156, "stack": 8,
         "spill_stores": 4, "spill_loads": 12}]
    assert _build.sass_counts(["flash_bwd"]) == []     # no listing kept


def test_chip_smoke_ptxas_table_reads_a_cached_build(tmp_path, monkeypatch):
    """chip_smoke's ptxas table needs no compile in its own process: a
    warm build directory (a second run, or one after the cuda tests)
    gives the same rows as a fresh build, with each instantiation's SASS
    counts from the kept listing and its dynamic shared memory from its
    library. A spill, or a kernel without wgmma or TMA, fails it."""
    import chip_smoke
    smem = {"flash_bwd_dkv_kernel": 101376, "flash_bwd_dq_kernel": 100352}
    monkeypatch.setattr(_build, "smem_bytes",
                        lambda stem, kernel, d, form: smem[kernel])
    _keep_logs(tmp_path, monkeypatch, {"flash_bwd": _ptxas_log()},
               {"flash_bwd": _sass_listing()})
    rows = chip_smoke.ptxas_table()
    assert [(r["kernel"], r["d"], r["form"], r["registers"], r["smem"],
             r["hgmma"], r["utmaldg"], r["ublkcp"]) for r in rows] == [
        ("dk+dv", 128, "none", 230, 101376, 32, 8, 2),
        ("dq + delta (fused bwd)", 128, "none", 156, 100352, 40, 8, 0)]
    _keep_logs(tmp_path, monkeypatch, {"flash_bwd": _ptxas_log(True)},
               {"flash_bwd": _sass_listing()})
    with pytest.raises(AssertionError, match="dq \\+ delta"):
        chip_smoke.ptxas_table()
    _keep_logs(tmp_path, monkeypatch, {"flash_bwd": _ptxas_log()},
               {"flash_bwd": _sass_listing().replace("HGMMA", "HMMA")})
    with pytest.raises(AssertionError, match="no wgmma"):
        chip_smoke.ptxas_table()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "empty")
    with pytest.raises(FileNotFoundError):   # no build: no report
        chip_smoke.ptxas_table()


# ------------------------------------------------------------- the trainer

def test_bert_at_d128_trains_as_the_jax_trainer():
    """BERT at head dim 128 (hidden 256, 2 heads, 2 layers, seq 128): 3
    steps of the port's trainer (flash attention, the plain versions on
    the CPU, remat on) against the JAX trainer on a 1-device mesh (naive
    attention), from the same weights and batches."""
    jcfg = jbert.bert_config(dtype="float32", attn_impl="naive", **WIDTH)
    tcfg = tbert.bert_config(dtype="float32", **WIDTH)
    assert tcfg.head_dim == D
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jt = JaxTrainer(lambda p, b: jbert.mlm_loss(p, jcfg, b,
                                                max_predictions=MAX_PRED),
                    jp, optax.adamw(LR, eps=EPS), mesh=mesh)
    model = tbert.Transformer(tcfg)
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jp)))
    tt = DistributedTrainer(
        lambda m, b: tbert.mlm_loss(m, b, max_predictions=MAX_PRED), model,
        adamw(model.parameters(), LR, eps=EPS), device="cpu")
    for i in range(3):
        data = tbert.synth_mlm_batch(np.random.RandomState(i), 4, SEQ,
                                     WIDTH["vocab_size"])
        jl, tl = float(jt.step(data)), tt.step(data).item()
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {i}")
    want = convert.params_from_jax(jax.tree.map(np.asarray, jt.params))
    got = model.state_dict()
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
