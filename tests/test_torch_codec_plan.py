"""The launch plan of the port's one-wave codec kernels
(``ops/compression/kernels.py::stream_plan``), on the CPU.

``int8_quantize``, ``onebit_unpack``, ``onebit_pack``,
``fp8_sr_quantize`` and ``int8_dequantize`` launch
``csrc/int8_quantize.cu``, ``csrc/onebit_unpack.cu``,
``csrc/onebit_pack.cu``, ``csrc/fp8_sr_quantize.cu`` and
``csrc/int8_dequantize.cu`` with a plan computed in Python: the elements
read one by one before the first 16-byte boundary (the head), the 16-byte
vectors from there on, the elements left after them (the tail), and a grid
of one wave at most. The kernels run only on the card
(``test_torch_kernels_cuda.py``); their index walk is simple, and the plan
is the part that is hard to get right, so it is held here: over sizes up
to 5·2^20 elements and every 4-byte offset of the pointer past a 16-byte
boundary (dequantize's vectors are its output's, always aligned: offset
0 only), with the 132 SMs of an H100 SXM, the plan covers [0, n) exactly
once as the kernels walk it, every vector it assigns is 16-byte aligned,
and the grid never exceeds its cap. Which dequantize instance reads a
view is held too. No tolerance: these are integers.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from byteps_tpu_torch.ops.compression import kernels as ob

SMS = 132                       # an H100 SXM
CAP = SMS * ob.CTAS_PER_SM      # one wave
ELEMS = 4                       # 4-byte elements: a float4 a vector
KERNELS = {"int8_quantize": ob.QUANT_VECS, "onebit_unpack": ob.UNPACK_VECS,
           "onebit_pack": ob.PACK_VECS, "fp8_sr_quantize": ob.FP8_VECS,
           "int8_dequantize": ob.DEQUANT_VECS}
# the kernels whose vectors are their output's, a fresh torch.empty: the
# wrappers plan them at offset 0 only
AT_ZERO = {"int8_dequantize"}
PLANS = settings(max_examples=80, deadline=None, database=None,
                 derandomize=True)

sizes = st.integers(1, 5 << 20)
offsets = st.sampled_from([0, 4, 8, 12])
kernels = st.sampled_from(sorted(KERNELS))


def _vector_touches(plan, vecs_per_thread):
    """How often each vector of the body is stored, as the kernels walk
    the plan: CTA b takes the chunks b, b + grid, ... of threads ·
    vecs_per_thread vectors (a chunk is a contiguous run of vectors,
    however its threads share it), the vectors past ``plan.vecs``
    masked."""
    chunk = ob.CTA_THREADS * vecs_per_thread
    nchunks = -(-plan.vecs // chunk)
    walked = np.concatenate([np.arange(b, nchunks, plan.grid, dtype=np.int64)
                             for b in range(plan.grid)])
    vecs = (walked[:, None] * chunk + np.arange(chunk)).ravel()
    return np.bincount(vecs[vecs < plan.vecs], minlength=plan.vecs)


def _plan(n, addr, kernel):
    """The offset the wrapper plans ``kernel`` at, and its plan."""
    addr = 0 if kernel in AT_ZERO else addr
    return addr, ob.stream_plan(n, addr, SMS, ELEMS, KERNELS[kernel])


@PLANS
@given(n=sizes, addr=offsets, kernel=kernels)
def test_plan_covers_every_element_exactly_once(n, addr, kernel):
    """CTA 0 reads the head [0, head) and the tail [end, n) one by one;
    the vectors cover [head, end) four elements each."""
    _, plan = _plan(n, addr, kernel)
    end = plan.head + ELEMS * plan.vecs
    assert min(plan.head, plan.vecs, plan.tail) >= 0
    assert end + plan.tail == n
    assert (_vector_touches(plan, KERNELS[kernel]) == 1).all()


@PLANS
@given(n=sizes, addr=offsets, kernel=kernels)
def test_plan_vectors_are_16_byte_aligned(n, addr, kernel):
    addr, plan = _plan(n, addr, kernel)
    assert 0 <= plan.head < ELEMS and 0 <= plan.tail < ELEMS
    assert plan.head + ELEMS * plan.vecs + plan.tail == n
    if plan.vecs:
        # vector v starts at byte addr + 4·head + 16·v
        assert (addr + 4 * plan.head) % ob.VEC_BYTES == 0


@PLANS
@given(n=sizes, addr=offsets, kernel=kernels)
def test_plan_grid_is_one_wave_at_most(n, addr, kernel):
    _, plan = _plan(n, addr, kernel)
    chunks = -(-plan.vecs // (ob.CTA_THREADS * KERNELS[kernel]))
    assert 1 <= plan.grid <= CAP
    assert plan.grid == max(1, min(CAP, chunks))   # no idle CTA


@pytest.mark.parametrize("kernel,grid", [("int8_quantize", 250),
                                         ("onebit_unpack", 125),
                                         ("onebit_pack", 125),
                                         ("fp8_sr_quantize", 500),
                                         ("int8_dequantize", 125)])
def test_a_gradient_bucket_is_one_wave(kernel, grid):
    """The trainer's default bucket (4,096,000 bytes of f32) takes one
    wave, every CTA one pass."""
    plan = ob.stream_plan(1_024_000, 0, SMS, ELEMS, KERNELS[kernel])
    assert plan == ob.StreamPlan(0, 256_000, 0, grid) and grid <= CAP


@PLANS
@given(n=sizes, addr=offsets)
def test_pack_plan_sizes_the_grid_to_its_instance(n, addr):
    """Pack's float4 instance takes 8,192 floats a CTA a pass, its
    4-byte-load instance (a view at a 4-byte offset) 2,048: every CTA
    makes one pass where one wave holds n, none is idle, and the head,
    vectors and tail are ``stream_plan``'s."""
    plan = ob.pack_plan(n, addr, SMS)
    per_cta = ob.CTA_THREADS * (ob.PACK_SCALARS if addr else
                                ELEMS * ob.PACK_VECS)
    assert plan[:3] == ob.stream_plan(n, addr, SMS, ELEMS, ob.PACK_VECS)[:3]
    assert 1 <= plan.grid <= CAP
    assert plan.grid * per_cta >= n or plan.grid == CAP
    assert (plan.grid - 1) * per_cta < n


@pytest.mark.parametrize("addr,grid", [(0, 125), (4, 500), (8, 500),
                                       (12, 500)])
def test_a_gradient_bucket_is_one_wave_of_either_pack_instance(addr, grid):
    assert ob.pack_plan(1_024_000, addr, SMS).grid == grid <= CAP


@pytest.mark.parametrize("n,addr", [(0, 0), (-1, 0), (8, 2), (8, 16),
                                    (8, -4)])
def test_plan_refuses_what_no_kernel_takes(n, addr):
    with pytest.raises(ValueError, match="no plan"):
        ob.stream_plan(n, addr, SMS, ELEMS, ob.QUANT_VECS)


@pytest.mark.parametrize("addr,head", [(0, 0), (4, 3), (8, 2), (12, 1)])
def test_the_head_of_a_short_view_is_the_whole_view(addr, head):
    """A view shorter than its head is read one by one, with no vector."""
    for n in range(1, 9):
        plan = ob.stream_plan(n, addr, SMS, ELEMS, ob.QUANT_VECS)
        assert plan.head == min(n, head) and plan.grid == 1
        assert plan.vecs == (n - plan.head) // ELEMS


@pytest.mark.parametrize("addr", range(16))
def test_dequantize_reads_words_where_each_float4s_codes_are_one_word(addr):
    """The word instance loads the four codes of float4 f, bytes addr + 4f
    to addr + 4f + 3, as one aligned 4-byte word. The wrapper must take
    it exactly where every float4's codes lie in one such word, and the
    byte instance wherever some float4's codes straddle two."""
    for base in (0, 4096):
        a = base + addr
        one_word = all((a + 4 * f) // 4 == (a + 4 * f + 3) // 4
                       for f in range(8))
        assert ob.dequantize_reads_words(a) == one_word
