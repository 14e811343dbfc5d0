"""The layout rule of the port's Hopper flash kernels, on CPU tensors.

The kernels read q, k, v and dO through TMA tensor maps over [b, s, h, d]
with boxes of [64 rows][64 columns] of one head, and the dk/dv kernel
brings each query tile's lse and delta in by a bulk copy. TMA needs a
16-byte-aligned base, row and batch strides that are positive multiples
of 16 bytes, a unit last stride and (for the box) a head stride of d.
``reads_in_place`` states that rule, ``kernel_layout`` copies an operand
that breaks it, and ``vector_layout`` does the same for the fp32 vectors.
The rule is plain stride arithmetic, so it is held here on the CPU; the
kernels' own reads of these views are held on the card
(``tests/test_torch_kernels_cuda.py``). What the kernels refuse outright
raises from ``check_kernel_inputs`` with the message named below.
"""

import pytest
import torch

from byteps_tpu_torch.ops import flash_attention as tfa

B, S, H = 2, 128, 4


_GEN = torch.Generator().manual_seed(0)


def _bf16(*shape):
    return torch.randn(*shape, generator=_GEN).to(torch.bfloat16)


def _views(d):
    """(name, tensor, read in place) for the views a caller passes."""
    qkv = _bf16(B, S, 3, H, d)                  # the model's packed projection
    wide = _bf16(B, S, H, d + 8)                # a head padded to d + 8
    flat = _bf16(B * S * H * d + 8)
    odd_rows = _bf16(B, S, H * d + 4)           # rows 8 bytes past a multiple
    return [
        ("contiguous", _bf16(B, S, H, d), True),
        ("qkv.unbind(2) q", qkv.unbind(2)[0], True),
        ("qkv.unbind(2) v", qkv.unbind(2)[2], True),
        ("a sequence slice", _bf16(B, 2 * S, H, d)[:, S:], True),
        ("[b, h, s, d] transposed", _bf16(B, H, S, d).transpose(1, 2), False),
        ("head padded to d + 8", wide[..., :d], False),
        ("base 2 bytes off", flat[1:1 + B * S * H * d].view(B, S, H, d),
         False),
        ("row stride not 16 bytes",
         odd_rows.as_strided((B, S, H, d), (S * (H * d + 4), H * d + 4, d, 1)),
         False),
        ("every other head", _bf16(B, S, 2 * H, d)[:, :, ::2], False),
    ]


@pytest.mark.parametrize("d", tfa.KERNEL_DS)
@pytest.mark.parametrize("i", range(9))
def test_reads_in_place_follows_the_tma_rule(d, i):
    name, t, in_place = _views(d)[i]
    assert tfa.reads_in_place(t) is in_place, name


@pytest.mark.parametrize("d", tfa.KERNEL_DS)
@pytest.mark.parametrize("i", range(9))
def test_kernel_layout_copies_only_what_tma_cannot_read(d, i):
    """A view the kernels read is passed as it is (no copy: the same
    storage); any other becomes a contiguous copy with the same values,
    which they read."""
    name, t, in_place = _views(d)[i]
    got = tfa.kernel_layout(t)
    if in_place:
        assert got is t, name
    else:
        assert got.data_ptr() != t.data_ptr() and got.is_contiguous(), name
        assert tfa.reads_in_place(got), name
    assert torch.equal(got, t), name


@pytest.mark.parametrize("case", ["contiguous", "offset", "strided"])
def test_vector_layout_gives_aligned_contiguous_lse(case):
    """lse and delta ([b, h, sq] fp32): kept when contiguous on a 16-byte
    boundary, else a fresh copy (an offset of one float, or a view over
    every other element)."""
    base = torch.arange(2 * B * H * S + 4, dtype=torch.float32)
    t = {"contiguous": base[:B * H * S].view(B, H, S),
         "offset": base[1:1 + B * H * S].view(B, H, S),
         "strided": base[:2 * B * H * S].view(B, H, 2 * S)[..., ::2]}[case]
    got = tfa.vector_layout(t)
    assert torch.equal(got, t)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert (got is t) == (case == "contiguous")


def test_non_4d_operand_is_not_read_in_place():
    assert not tfa.reads_in_place(_bf16(B * S, H, 64))


@pytest.mark.parametrize("case,exc,match", [
    ("fp16", TypeError, "bfloat16"),
    ("head_dim_32", NotImplementedError, "head_dim 32"),
    ("seq_96", ValueError, "multiples of 64"),
    ("three_dims", ValueError, r"\[b, s, h, d\]"),
    ("kv_heads", ValueError, "do not agree"),
])
def test_what_the_kernels_refuse_raises_with_its_message(case, exc, match):
    """Refused outright (no copy makes them readable): another dtype,
    another head dim, a length off the 64-row tile, a tensor that is not
    [b, s, h, d], k/v of another head count."""
    q = k = v = _bf16(B, S, H, 64)
    if case == "fp16":
        q = k = v = torch.zeros(B, S, H, 64, dtype=torch.float16)
    elif case == "head_dim_32":
        q = k = v = _bf16(B, S, H, 32)
    elif case == "seq_96":
        q = k = v = _bf16(B, 96, H, 64)
    elif case == "three_dims":
        q = k = v = _bf16(B * S, H, 64)
    elif case == "kv_heads":
        k = v = _bf16(B, S, 2 * H, 64)
    with pytest.raises(exc, match=match):
        tfa.check_kernel_inputs(q, k, v)
