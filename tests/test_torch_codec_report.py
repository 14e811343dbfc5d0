"""What ``chip_smoke.py`` reports of the codec kernels, on the CPU: the
gate of phase 1's codec table (no spill, and the 16-byte access each
one-wave kernel's design must hold in every instance but pack's 4-byte
one, which the report names exempt), the common-path instruction count
that ``--codec-ab`` prints for fp8 SR, fp8's INT32 operations in its bound,
the plan constant and parent entries ``--codec-ab`` reads from another
checkout, and each codec kernel's time and launches in phase 4's profiled
step. The
inputs are synthetic ptxas logs and SASS listings shaped as nvcc and
cuobjdump write them; the card's own are read on the chip. No
tolerance but the bound's float rounding."""

import pytest

import chip_smoke
from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops.compression import kernels as ob

# mangled names as nvcc writes them: an anonymous namespace, a length
# prefix, the template arguments
NS = "_ZN12_GLOBAL__N_1"
KERNELS = {
    "onebit_pack": [f"{NS}18onebit_pack_kernelILb0EEEvPKfPjxx",
                    f"{NS}18onebit_pack_kernelILb1EEEvPKfPjxx"],
    "onebit_unpack": [f"{NS}20onebit_unpack_kernelEPKjPfxx"],
    "int8_quantize": [f"{NS}20int8_quantize_kernelILb1EEEvPKfPaxix9Int8Codes"],
    "int8_dequantize": [f"{NS}22int8_dequantize_kernelILb0EEEvPKaPfxxf",
                        f"{NS}22int8_dequantize_kernelILb1EEEvPKaPfxxf"],
    "fp8_sr_quantize": [f"{NS}13fp8_sr_kernelILi3ELi121ELb1EEEvPKfPhxix8Fp8C"],
}
WIDE = {"onebit_pack": "LDG.E.128.CONSTANT R8, desc[UR4][R2.64]",
        "onebit_unpack": "STG.E.128 desc[UR4][R2.64], R8",
        "int8_quantize": "LDG.E.128.CONSTANT R8, desc[UR4][R2.64]",
        "fp8_sr_quantize": "LDG.E.128.CONSTANT R8, desc[UR4][R2.64]",
        "int8_dequantize": "STG.E.128 desc[UR4][R2.64], R8"}
# the one instance the gate exempts: pack's 4-byte-load one
EXEMPT = KERNELS["onebit_pack"][0]


def _log(names, spill=0):
    out = "ptxas info    : 0 bytes gmem\n"
    for name in names:
        out += (f"ptxas info    : Compiling entry function '{name}' for "
                "'sm_90a'\n"
                f"ptxas info    : Function properties for {name}\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, "
                f"{spill} bytes spill loads\n"
                "ptxas info    : Used 40 registers, 928 bytes cmem[0]\n")
    return out


def _listing(functions):
    """cuobjdump -sass of a library: {mangled name: [instruction, ...]},
    16 bytes an instruction."""
    out = "\tcode for sm_90a\n"
    for name, ops in functions.items():
        out += f"\t\tFunction : {name}\n" + "".join(
            f"        /*{16 * i:04x}*/                   {op} ;\n"
            for i, op in enumerate(ops))
    return out


def _keep(tmp_path, monkeypatch, drop=(), spill=None):
    """A build directory holding each codec source's ptxas log and SASS
    listing: every instance with its 16-byte access but pack's 4-byte
    one, less the access of the instances in ``drop``, a spill in
    ``spill``."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    for stem, names in KERNELS.items():
        _build._log_path(stem).write_text(
            _log(names, 8 if stem == spill else 0))
        _build._sass_path(stem).write_text(_listing({
            name: (["LDG.E.CONSTANT R8, desc[UR4][R2.64]"]
                   if name == EXEMPT or name in drop
                   else [WIDE.get(stem, "LDG.E R8, desc[UR4][R2.64]")])
            + ["EXIT"] for name in names}))


def test_codec_table_names_packs_four_byte_instance_exempt(tmp_path,
                                                           monkeypatch):
    _keep(tmp_path, monkeypatch)
    rows = {(r["kernel"], tuple(r["args"])): r
            for r in chip_smoke.codec_table()}
    assert rows[("onebit_pack_kernel", (0,))]["ldg.e.128"] == 0
    assert rows[("onebit_pack_kernel", (1,))]["ldg.e.128"] == 1
    assert rows[("fp8_sr_kernel", (3, 121, 1))]["ldg.e.128"] == 1
    # dequantize's byte-load instance is not exempt: it stores float4s
    assert rows[("int8_dequantize_kernel", (0,))]["stg.e.128"] == 1
    assert rows[("int8_dequantize_kernel", (1,))]["stg.e.128"] == 1
    assert set(chip_smoke.WIDE_ACCESS) == set(WIDE)


@pytest.mark.parametrize("stem,index", [("onebit_pack", 1),
                                        ("fp8_sr_quantize", 0),
                                        ("int8_quantize", 0),
                                        ("int8_dequantize", 0),
                                        ("int8_dequantize", 1)])
def test_codec_table_fails_a_wide_instance_without_its_access(
        tmp_path, monkeypatch, stem, index):
    _keep(tmp_path, monkeypatch, drop=(KERNELS[stem][index],))
    with pytest.raises(AssertionError, match="128-bit"):
        chip_smoke.codec_table()


@pytest.mark.parametrize("stem", ["onebit_pack", "fp8_sr_quantize"])
def test_codec_table_fails_a_spill(tmp_path, monkeypatch, stem):
    _keep(tmp_path, monkeypatch, spill=stem)
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.codec_table()


def test_common_path_skips_the_divides_call_and_stops_at_the_loop():
    """The main loop's pass from the target of its back edge: a branch
    over the divide's call is taken, one over plain code falls through,
    an unconditional one is taken; the setup before the loop and the
    back edge are not counted. Without a loop, the entry to EXIT, past a
    MUFU."""
    fp8 = KERNELS["fp8_sr_quantize"][0]
    old = f"{NS}13fp8_sr_kernelILi3ELi121EEEvPKfPhxffj"
    sass = _listing({
        fp8: ["S2R R0, SR_TID.X", "@P0 EXIT",
              "LDG.E.128.CONSTANT R8, desc[UR4][R2.64]",      # 0x20: head
              "FMUL R4, R8, R9", "@P1 BRA 0x70",
              "CALL.REL.NOINC 0x100", "FFMA R4, R5, R6, R7",
              "LOP3.LUT R5, R4, 0x7f, RZ, 0xc0, !PT",        # 0x70
              "@!P2 BRA 0xb0", "IADD3 R5, R5, 0x1, RZ", "BRA 0xc0",
              "IADD3 R5, R5, 0x2, RZ",                       # 0xb0
              "STG.E desc[UR4][R2.64], R5",                  # 0xc0
              "@!P3 BRA 0x20", "EXIT"],
        old: ["LDG.E R0, desc[UR4][R2.64]", "@!P0 BRA 0x40",
              "MUFU.RCP R6, R9", "FFMA R7, R6, -R9, 1",
              "IMAD R1, R0, 0x3, RZ", "STG.E.U8 desc[UR4][R2.64], R1",
              "EXIT", "BRA 0x70"]})
    assert chip_smoke.common_path(sass) == {
        ("fp8_sr_kernel", (3, 121, 1)): 8,
        ("fp8_sr_kernel", (3, 121)): 5}


def test_fp8_bound_counts_the_contracts_integer_operations():
    """The normal-range path's 18 INT32 operations an element (the hash
    10, the code 8) at 132 · 64 · 1.98e9 a second take less than the 5n
    bytes at 3.35e12: the bound is the bytes'. The other codec rows keep
    their fp32 counts."""
    n = 1_024_000
    b = chip_smoke.quant_bounds(n)
    assert chip_smoke.FP8_INT_OPS == 18
    assert b["fp8_sr_quantize"]["flops"] == 18 * n
    assert 18 * n / (132 * 64 * 1.98e9) < 5 * n / 3.35e12
    assert b["fp8_sr_quantize"]["bound_by"] == "bytes"
    assert b["fp8_sr_quantize"]["bound_ms"] == pytest.approx(
        5 * n / 3.35e12 * 1e3, rel=1e-12)
    assert b["fp8_sr_quantize"]["bytes"] == 5 * n
    assert b["int8_quantize"]["bound_by"] == "bytes"
    assert b["int8_quantize"]["flops"] == 4 * n


def test_codec_ab_reads_each_sides_plan_constant(tmp_path):
    """A scratch copy of the tree with another float4 count times its
    kernel on its own plan; a parent whose kernels.py states none falls
    back to this checkout's."""
    comp = tmp_path / "byteps_tpu_torch" / "ops" / "compression"
    comp.mkdir(parents=True)
    (comp / "kernels.py").write_text("QUANT_VECS = 4\nFP8_VECS = 8   # x\n")
    assert chip_smoke._plan_vecs(tmp_path, "fp8_sr_quantize", 2) == 8
    assert chip_smoke._plan_vecs(tmp_path, "onebit_pack", 3) == 3
    assert chip_smoke._plan_vecs(chip_smoke.ROOT, "fp8_sr_quantize",
                                 0) == ob.FP8_VECS
    assert chip_smoke._plan_vecs(chip_smoke.ROOT, "int8_dequantize",
                                 0) == ob.DEQUANT_VECS


def test_codec_ab_knows_every_codec_kernel_before_and_after_the_plan():
    """Every codec kernel can be timed against a parent: its plan constant,
    its entry before the plan (dequantize's (q, out, n, scale, stream)),
    and the planned entry's arguments, the plan's head only where the
    vectors are the input's (dequantize's instance after the grid)."""
    assert set(chip_smoke.PLAN_VECS) == set(chip_smoke.BEFORE_PLAN) == set(
        chip_smoke.CODEC_STEMS)
    P, L, F, I = chip_smoke._P, chip_smoke._L, chip_smoke._F, chip_smoke._I
    assert chip_smoke.BEFORE_PLAN["int8_dequantize"] == (
        "bps_int8_dequantize", [P, P, L, F, P])
    assert _build.SIGNATURES["int8_dequantize"] == (
        "bps_int8_dequantize_planned", [P, P, L, L, I, I, F, P])
    for stem in chip_smoke.CODEC_STEMS:
        _, args = _build.SIGNATURES[stem]
        head = stem not in chip_smoke.NO_HEAD
        assert args[2:5 + head] == [L] + [I] * head + [L, I], stem


def test_codec_in_step_splits_dequantize_from_quantize():
    """Phase 4's per-kernel line: names as the profiler reports them, each
    launch counted once under its own stem, other kernels left out."""
    ns = "void (anonymous namespace)::"
    events = [(f"{ns}int8_quantize_kernel<true, Int8Codes>(float const*, "
               "signed char*, long long, int, long long, float)", 4.0),
              (f"{ns}int8_dequantize_kernel<true>(signed char const*, "
               "float*, long long, long long, float)", 3.0),
              (f"{ns}int8_dequantize_kernel<true>(signed char const*, "
               "float*, long long, long long, float)", 5.0),
              ("void at::native::vectorized_elementwise_kernel<4>", 9.0),
              (f"{ns}fp8_sr_kernel<3, 121, true>(float const*)", 7.0)]
    got = chip_smoke.codec_in_step(events)
    assert got == {"int8_quantize": {"ms": 0.004, "launches": 1},
                   "int8_dequantize": {"ms": 0.008, "launches": 2},
                   "fp8_sr_quantize": {"ms": 0.007, "launches": 1}}
