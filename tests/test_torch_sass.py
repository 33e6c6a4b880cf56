"""The hit-path SASS count (parcels_tpu_torch/ops/sass.py) on listings in
``cuobjdump -sass``'s format: what it keeps, what it skips as slow paths."""

import pytest

from parcels_tpu_torch.ops import sass

HEAD = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_16kernelEv
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
"""


def _listing(lines):
    """The listing of ``lines``; a line ending in ':' only names the address
    of the next instruction (``_addr``)."""
    out = [HEAD]
    for k, ln in enumerate(lines):
        if not ln.endswith(":"):
            out.append(f"        /*{16 * k:04x}*/                   {ln} ;"
                       f"                 /* 0x000fe40000000800 */")
            out.append("                                                   /* 0x000fe40000000800 */")
    return "\n".join(out)


def _count(lines):
    fns = sass.functions(_listing(lines))
    assert list(fns) == ["_ZN12_GLOBAL__N_16kernelEv"]
    return sass.hit_path(fns["_ZN12_GLOBAL__N_16kernelEv"])


def _addr(lines, label):
    """The address the listing gives the instruction after ``label``."""
    return f"0x{16 * (lines.index(label + ':') + 1):x}"


def test_straight_line_counts_every_instruction_but_nop():
    hp = _count(["S2R R0, SR_TID.X", "LDG.E R2, desc[UR4][R4.64]", "FMUL R3, R2, R2",
                 "STG.E desc[UR4][R6.64], R3", "EXIT", "NOP"])
    assert hp["count"] == hp["reachable"] == 5
    assert hp["by_op"] == {"S2R": 1, "LDG": 1, "FMUL": 1, "STG": 1, "EXIT": 1}


@pytest.mark.parametrize("negated", [True, False])
def test_trig_slow_path_is_skipped(negated):
    """A branch on a predicate last set by the trig range test continues on
    its fast side only, whichever way the compiler lays the branch out; a
    spill (STL/LDL on the fast path) counts."""
    lines = ["FMUL R1, R0, 0.63661974668502807617",
             "FSETP.GE.AND P0, PT, |R0|, 105615, PT",
             "STL [R1+0x20], R22",          # a spill: on the hit path
             "IADD3 R5, P1, R3, 0x1, RZ",   # sets P1 (a carry), not P0
             None,
             "slow:",
             "LDG.E.CONSTANT R7, desc[UR6][R8.64]",
             "STL [R9], R7",
             "LDL R10, [R9]",
             "BRA join",
             "fast:",
             "FFMA R11, R1, R1, R1",
             "join:",
             "LDL R22, [R1+0x20]",
             "EXIT"]
    if negated:
        lines[4] = "@!P0 BRA fast"
    else:
        # @P0 BRA slow: the fall-through is the fast side; move the fast block first
        lines[4] = "@P0 BRA slow"
        lines = lines[:5] + ["FFMA R11, R1, R1, R1", "BRA join"] + lines[5:10] + lines[12:]
    lines = [ln.replace("BRA fast", f"BRA {_addr(lines, 'fast')}") if "BRA fast" in ln else ln
             for ln in lines]
    lines = [ln.replace("BRA slow", f"BRA {_addr(lines, 'slow')}") if "BRA slow" in ln else ln
             for ln in lines]
    lines = [ln.replace("BRA join", f"BRA {_addr(lines, 'join')}") if "BRA join" in ln else ln
             for ln in lines]
    hp = _count(lines)
    ops = hp["by_op"]
    assert ops["STL"] == 1 and ops["LDL"] == 1 and "LDG" not in ops and ops["FFMA"] == 1
    assert hp["reachable"] > hp["count"]


def test_calls_are_skipped_and_both_sides_of_data_branches_count():
    lines = ["FCHK P0, R2, R3",
             "@!P0 BRA 0x40",
             "MOV R4, R2",
             "CALL.REL.NOINC 0x90",
             "ISETP.GE.AND P1, PT, R0, 0x10, PT",   # 0x40
             "@P1 BRA 0x70",
             "FADD R5, R5, 1",
             "STG.E desc[UR4][R6.64], R5",          # 0x70
             "EXIT",
             "FADD R2, R2, R3",                     # 0x90: the subroutine
             "RET.REL.NODEC R20 0x0"]
    hp = _count(lines)
    assert hp["count"] == 7  # FCHK, BRA, ISETP, BRA, FADD, STG, EXIT
    assert "CALL" not in hp["by_op"] and "RET" not in hp["by_op"]


def test_issue_ms():
    # 2312 instructions on 2^23 lanes, 132 SMs at 1980 MHz
    assert sass.issue_ms(2312, 1 << 23, 132, 1980.0) == pytest.approx(0.57973, rel=1e-4)
