#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``byteps_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases (any failure raises and the exit code is not 0):

  1. toolchain: torch and CUDA versions, nvcc, the card's name and power
     limit; build the Hopper kernels from ``byteps_tpu_torch/csrc``.
  2. kernel checks at the flagship attention shape (s 512, h 16, d 64,
     bf16, seeded): b 4 causal and not, and b 8 (the training phase's
     batch). Each kernel is held against its plain PyTorch version on the
     card; the fused backward also against autograd of the plain forward.
     Times (CUDA events, median of 30 launches, L2 flushed before each) of
     the kernel, its plain version and the library call
     (``scaled_dot_product_attention``, timed as a yardstick only; the
     port never calls it), beside the least time the card could take.
  3. training: BERT-large at full width (24 x 1024 x 16, vocab 30522,
     seq 512, bf16 compute over fp32 params, remat), random weights from
     seed 0, through the port's ``DistributedTrainer`` with AdamW(1e-4,
     weight_decay 1e-4): 3 steps on one fixed ``synth_mlm_batch`` of 8.
     Losses must be finite and falling, and the kernel launch counters,
     zeroed just before, must read 3 x 24 x 2 forward launches (remat runs
     each layer's forward twice) and 3 x 24 fused-backward launches. Step
     1 is repeated with ``attn_impl="naive"`` (plain attention on the
     card) as the reference for the loss.
  4. one JSON line ``{"kernels": [...]}``, the card's name and power limit,
     and as the last line ``{"ok": true, "device": {...}}``.

It exits with code 2, printing no result, when no CUDA device is present
or when the ``byteps_tpu_torch`` package is not beside it.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM, NVIDIA data sheet: dense bf16 tensor-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# the Pallas kernels the Hopper kernels replace
REPLACES = {
    "flash_fwd": "byteps_tpu/ops/flash_attention.py:172",
    "flash_bwd_fused": "byteps_tpu/ops/flash_attention.py:489",
}
SOURCES = {
    "flash_fwd": "byteps_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_fused": "byteps_tpu_torch/csrc/flash_bwd.cu",
}
# max |kernel - plain| <= REL * max |plain| (bf16 outputs: both sides round
# at the same points and differ by fp32 summation order, one bf16 step is
# 2^-8 relative); lse is fp32 and gets an absolute bound
REL_TOL = 1e-2
REL_TOL_AUTOGRAD = 3e-2     # vs autograd of the plain forward, whose P and
#                             dS are not rounded to bf16
LSE_TOL = 1e-3
TRAIN_BATCH, SEQ, STEPS = 8, 512, 3


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------- phase 1

def toolchain():
    from byteps_tpu_torch.ops import _build
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = _build.nvcc_path()
    log(subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                       check=True).stdout.strip().splitlines()[-1])
    log(f"card: {card_line()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(sorted(_build.SIGNATURES))})")


# ------------------------------------------------------------- phase 2

def _inputs(b, s, h, d, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g).to("cuda", torch.bfloat16)
            for _ in range(4)]


def _rel_err(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def time_ms(fn, n=30, flush=None):
    """Median over n launches of fn, each timed with CUDA events, with the
    L2 cache flushed before each launch (outside the timed span)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bounds(b, s, h, d, causal):
    """Least time (ms) the card could take: max(FLOPs / peak, bytes /
    rate), each input read once and each output written once. Causal
    counts only the unmasked (q, k) pairs this data needs."""
    pairs = s * (s + 1) / 2 if causal else s * s
    row = b * s * h * d * 2                       # one [b, s, h, d] bf16
    lse = b * h * s * 4
    fwd = (4 * b * h * d * pairs, 4 * row + lse)        # q k v -> out, lse
    bwd = (10 * b * h * d * pairs, 7 * row + lse)       # q k v dO lse -> dq dk dv
    out = {}
    for name, (flops, nbytes) in (("flash_fwd", fwd),
                                  ("flash_bwd_fused", bwd)):
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = {"flops": flops, "bytes": nbytes,
                     "bound_ms": max(t_ops, t_mem),
                     "bound_by": "operations" if t_ops >= t_mem else "bytes"}
    return out


def check_kernels():
    from byteps_tpu_torch.ops import flash_attention as fa
    worst = {"flash_fwd": 0.0, "flash_bwd_fused": 0.0}
    for b, causal in ((4, False), (4, True), (TRAIN_BATCH, False)):
        q, k, v, do = _inputs(b, SEQ, 16, 64, seed=b + causal)
        out, lse = fa.flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
        e_out, r_out = _rel_err(out, ref_out)
        e_lse = (lse - ref_lse).abs().max().item()
        dq, dk, dv = fa.flash_bwd_fused(q, k, v, do, lse, causal)
        torch.cuda.synchronize()
        plain = fa.flash_bwd_fused_plain(q, k, v, do, lse, causal)
        qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))
        fa.flash_fwd_plain(qa, ka, va, causal)[0].backward(do)
        tag = f"b{b} s{SEQ} h16 d64 {'causal' if causal else 'full'}"
        log(f"[check {tag}] fwd out err {e_out:.3e} (rel {r_out:.2e}) "
            f"lse err {e_lse:.3e}")
        if not (r_out <= REL_TOL and e_lse <= LSE_TOL):
            raise AssertionError(f"flash_fwd disagrees with its plain "
                                 f"version at {tag}")
        worst["flash_fwd"] = max(worst["flash_fwd"], e_out)
        for got, ref, auto, name in zip((dq, dk, dv), plain,
                                        (qa.grad, ka.grad, va.grad),
                                        ("dq", "dk", "dv")):
            e, r = _rel_err(got, ref)
            ea, ra = _rel_err(got, auto)
            log(f"[check {tag}] bwd {name} err {e:.3e} (rel {r:.2e}); vs "
                f"autograd of the plain forward {ea:.3e} (rel {ra:.2e})")
            if not (r <= REL_TOL and ra <= REL_TOL_AUTOGRAD):
                raise AssertionError(f"flash_bwd_fused {name} disagrees at "
                                     f"{tag}")
            worst["flash_bwd_fused"] = max(worst["flash_bwd_fused"], e)
    return worst


def time_kernels():
    """Kernel, plain version and library call at the training phase's
    attention shape (b 8, s 512, h 16, d 64, non-causal)."""
    import torch.nn.functional as F
    from byteps_tpu_torch.ops import flash_attention as fa
    b, s, h, d = TRAIN_BATCH, SEQ, 16, 64
    q, k, v, do = _inputs(b, s, h, d, seed=99)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    _, lse = fa.flash_fwd(q, k, v)
    res = {
        "flash_fwd": {
            "ms": time_ms(lambda: fa.flash_fwd(q, k, v), flush=flush),
            "plain_ms": time_ms(lambda: fa.flash_fwd_plain(q, k, v), n=10,
                                flush=flush),
        },
        "flash_bwd_fused": {
            "ms": time_ms(lambda: fa.flash_bwd_fused(q, k, v, do, lse),
                          flush=flush),
            "plain_ms": time_ms(
                lambda: fa.flash_bwd_fused_plain(q, k, v, do, lse), n=10,
                flush=flush),
        },
    }
    # yardstick only: the library's fused attention on the same inputs,
    # [b, h, s, d] views. Its backward is timed alone (autograd.grad on a
    # retained graph), the same work as the fused backward kernel.
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    res["flash_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt), flush=flush)
    o = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    res["flash_bwd_fused"]["library_ms"] = time_ms(
        lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True),
        flush=flush)
    bd = bounds(b, s, h, d, causal=False)
    for name, r in res.items():
        r.update(bd[name])
        log(f"[time {name} b{b} s{s} h{h} d{d}] kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.1f} MB); "
            f"kernel at {r['bound_ms'] / r['ms']:.1%} of the bound")
    return res


# ------------------------------------------------------------- phase 3

_KERNEL_GROUPS = (      # first match wins; names as the profiler reports them
    ("flash (port)", ("flash_fwd_kernel", "flash_bwd_")),
    ("nccl", ("nccl",)),
    ("matmul", ("gemm", "xmma", "cutlass", "matmul", "nvjet", "sm90_")),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
    ("embedding", ("embedding", "index", "scatter", "gather", "sort",
                   "radix", "segment")),
    ("softmax / reductions", ("softmax", "reduce", "norm", "sum", "max",
                              "mean")),
    ("copies", ("copy", "memcpy", "memset", "cat", "fill")),
)


def profile_step(trainer, data):
    """One more step under torch.profiler: device time by kernel group and
    the device's idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t = time.perf_counter()
        trainer.step(data)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # device work only: user annotations ("Optimizer.step#...") also ride
    # the device track and would count their span as one more kernel
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.name]
    if not kernels:
        log("[profile] the profiler recorded no device activity: device "
            "breakdown not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    groups, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        low = e.name.lower()
        g = next((g for g, keys in _KERNEL_GROUPS
                  if any(k in low for k in keys)), "other elementwise")
        groups[g] = groups.get(g, 0.0) + us
    total = sum(groups.values())
    log(f"[profile] step wall {wall_us / 1e3:.2f} ms, {len(kernels)} device "
        f"ops, device busy {busy / 1e3:.2f} ms (idle share "
        f"{1 - busy / wall_us:.3f}), summed device time {total / 1e3:.2f} ms")
    for g, us in sorted(groups.items(), key=lambda x: -x[1]):
        log(f"[profile]   {g:24s} {us / 1e3:9.3f} ms  {us / total:6.1%}")
    for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:12]:
        log(f"[profile]   top {us / 1e3:9.3f} ms  {name[:110]}")


def train():
    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.models.flops import (
        mfu, transformer_train_flops_per_sample)
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer

    cfg = bert.bert_large(max_seq=SEQ)
    max_pred = max(1, int(0.2 * SEQ))
    data = bert.synth_mlm_batch(np.random.RandomState(0), TRAIN_BATCH, SEQ,
                                cfg.vocab_size)

    def loss_fn(model, batch):
        return bert.mlm_loss(model, batch, max_predictions=max_pred)

    def make_trainer(c):
        model = bert.Transformer(c, generator=torch.Generator().manual_seed(0))
        return DistributedTrainer(loss_fn, model,
                                  adamw(model.parameters(), 1e-4))

    t0 = time.perf_counter()
    trainer = make_trainer(cfg)     # device=None: the card
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"[train] bert_large {n_params / 1e6:.1f}M params on "
        f"{trainer.device}, built in {time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd.launches = 0
    fa.flash_bwd_fused.launches = 0
    losses, times = [], []
    for _ in range(STEPS):
        t = time.perf_counter()
        loss = trainer.step(data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
    launches = {"flash_fwd": fa.flash_fwd.launches,
                "flash_bwd_fused": fa.flash_bwd_fused.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fps = transformer_train_flops_per_sample(cfg, SEQ, lm_positions=max_pred)

    def rates(step_s):
        sps = TRAIN_BATCH / step_s
        util = mfu(sps, fps)
        return (f"{step_s * 1e3:.1f} ms = {sps:.2f} samples/s, "
                f"{sps * fps / 1e12:.1f} model TFLOP/s, mfu "
                + ("not known for this card" if util is None
                   else f"{util:.4f}"))

    log(f"[train] losses {losses}")
    log(f"[train] step times s {times}; peak memory {peak_gb:.2f} GB; "
        f"fastest of steps 2-3: {rates(min(times[1:]))}")
    log(f"[train] kernel launches in the 3 steps: {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    want = {"flash_fwd": STEPS * cfg.layers * 2,
            "flash_bwd_fused": STEPS * cfg.layers}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")

    # past the counted window: steadier step times, then one profiled step
    more = []
    for _ in range(STEPS):
        t = time.perf_counter()
        trainer.step(data)
        torch.cuda.synchronize()
        more.append(time.perf_counter() - t)
    log(f"[train] steps 4-6 s {more}: median "
        f"{rates(statistics.median(more))}")
    profile_step(trainer, data)
    del trainer

    # reference for the loss: step 1 with the plain attention on the card
    naive = make_trainer(bert.bert_large(max_seq=SEQ, attn_impl="naive"))
    naive_loss = naive.step(data).item()
    diff = abs(naive_loss - losses[0])
    log(f"[train] step-1 loss: kernels {losses[0]:.6f}, naive attention "
        f"{naive_loss:.6f}, |diff| {diff:.3e}")
    if not diff <= 2e-2:
        raise AssertionError("kernel path and naive path disagree on the "
                             "step-1 loss")
    del naive
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "byteps_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: byteps_tpu_torch not found beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False

    toolchain()
    worst = check_kernels()
    timing = time_kernels()
    launches = train()

    card = card_line()
    kernels = []
    for name in ("flash_fwd", "flash_bwd_fused"):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "ok": True, "tolerance": f"max err <= {REL_TOL} * max|plain|",
            "timed_shape": [TRAIN_BATCH, SEQ, 16, 64], "card": card,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
