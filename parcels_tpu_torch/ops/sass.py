"""Count the SASS instructions a lane of a built kernel issues on its hit path.

``cuobjdump -sass`` prints each kernel as a list of instructions with the
addresses their branches take. ``hit_path`` cuts a kernel into basic blocks and counts the
instructions of the blocks reachable from its entry without entering a slow
path: a block that calls a subroutine (the slow paths of IEEE division and
square root), or the side of a branch taken when a trig argument fails the
``|x| < 105615`` test (the large-argument reduction of ``cosf``/``sinf``,
which runs in local memory). Each block counts once and ``NOP`` is
excluded. A branch-free kernel body is counted exactly; where a kernel
branches on its data, both sides count, so the figure is an upper bound; a
loop body counts once. Register spills (``STL``/``LDL`` outside the trig
reduction) stay in the count.

``issue_ms`` turns a count into the least time an H100 takes to issue it:
each SM issues one warp instruction a clock on each of its 4 schedulers,
128 lanes a clock, whatever the instruction.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

__all__ = ["LANES_PER_SM_CLOCK", "functions", "hit_path", "issue_ms", "sass_of"]

#: lanes an SM issues a clock: 4 schedulers x one 32-lane warp instruction
LANES_PER_SM_CLOCK = 128

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"\b0x([0-9a-f]+)\b")
_PRED = re.compile(r"^@!?U?P[T0-9]+\s+")
_ENDS = ("BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "KILL")
#: the fast-path bound of the trig range reduction: |x| >= this reduces in local memory
_TRIG_RANGE = "105615"


def sass_of(lib: Path) -> str:
    """``cuobjdump -sass`` of a shared library built by ``_build``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout


def functions(text: str) -> dict:
    """{kernel name: [(address, predicated, opcode, operands, text)]}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        m = _INSTR.search(line)
        if m:
            raw = m.group(2).strip()
            pred = bool(_PRED.match(raw))
            op, _, rest = _PRED.sub("", raw).partition(" ")
            cur.append((int(m.group(1), 16), pred, op, rest, raw))
    return out


def _blocks(instrs):
    """Basic blocks: (list of instructions, successor block indices)."""
    addr_at = {ins[0]: k for k, ins in enumerate(instrs)}

    def target(ins):
        m = _TARGET.search(ins[3])
        return addr_at.get(int(m.group(1), 16)) if m else None

    leaders = {0}
    for k, ins in enumerate(instrs):
        if ins[2].split(".")[0] in _ENDS:
            leaders.add(k + 1)
            t = target(ins)
            if t is not None and ins[2].startswith("BRA"):
                leaders.add(t)
    starts = sorted(s for s in leaders if s < len(instrs))
    block_of = {s: b for b, s in enumerate(starts)}
    blocks = []
    for b, s in enumerate(starts):
        e = starts[b + 1] if b + 1 < len(starts) else len(instrs)
        body = instrs[s:e]
        last = body[-1]
        op = last[2].split(".")[0]
        succ = []
        if op == "BRA":
            t = target(last)
            if t is not None:
                succ.append(block_of[t])
            if last[1] and e < len(instrs):
                succ.append(block_of[e])
        elif op in ("EXIT", "RET", "KILL", "BRX", "JMX", "JMP"):
            if last[1] and e < len(instrs):
                succ.append(block_of[e])
        elif e < len(instrs):
            succ.append(block_of[e])
        blocks.append((body, succ))
    return blocks


def _set_predicates(ins, writer):
    """Record ``ins`` as the last writer of each predicate it sets: its first
    operand, or the carry out after a register (as IADD3 and LEA write it);
    ``R2P PR`` sets them all."""
    ops = [o.strip() for o in ins[3].split(",")]
    if ops and ops[0] == "PR":
        writer.clear()
    elif ops and re.fullmatch(r"U?P[0-6]", ops[0]):
        writer[ops[0]] = ins
    elif len(ops) > 1 and re.fullmatch(r"U?P[0-6]", ops[1]) and ops[0].startswith("R"):
        writer[ops[1]] = ins


def hit_path(items) -> dict:
    """Hit-path count of one kernel (``functions(...)[name]``): instructions
    of the blocks reachable without entering a slow path (``count``), of
    every block reachable from the entry (``reachable``), and the hit-path
    count by opcode (``by_op``).

    The blocks are walked in address order, from the entry along the hot
    path only, keeping the last instruction that set each predicate: a
    conditional branch on a predicate last set by the trig range test
    (``FSETP.GE ... |x|, 105615``) continues on its fast side alone, and a
    block that calls a subroutine is not entered."""
    blocks = _blocks(items)
    hot, reach, writer = [], {0} if blocks else set(), {}
    for b, (body, succ) in enumerate(blocks):
        if b not in reach:
            continue
        if any(ins[2].split(".")[0] == "CALL" for ins in body):
            continue
        hot.append(b)
        for ins in body:
            _set_predicates(ins, writer)
        last = body[-1]
        nxt = succ
        m = re.match(r"@(!?)(U?P[0-6]) ", last[4])
        if last[2].startswith("BRA") and m:
            w = writer.get(m.group(2))
            if w is not None and w[2].startswith("FSETP.GE") and _TRIG_RANGE in w[3]:
                fall = [x for x in succ if x == b + 1]
                taken = [x for x in succ if x != b + 1]
                # @!P BRA: the target takes |x| < bound; @P BRA: the fall-through does
                nxt = taken if m.group(1) == "!" else fall
        reach.update(nxt)

    def count(bs):
        return [ins for b in sorted(bs) for ins in blocks[b][0] if ins[2] != "NOP"]

    every, todo = set(), [0] if blocks else []
    while todo:
        b = todo.pop()
        if b not in every:
            every.add(b)
            todo.extend(blocks[b][1])
    path = count(hot)
    by_op = Counter(ins[2].split(".")[0] for ins in path)
    return dict(count=len(path), reachable=len(count(every)), by_op=dict(by_op.most_common()))


def issue_ms(count: int, lanes: int, sms: int, clock_mhz: float) -> float:
    """Milliseconds an H100 takes to issue ``count`` instructions on each of
    ``lanes`` lanes at ``clock_mhz``."""
    return 1e3 * count * lanes / (sms * LANES_PER_SM_CLOCK * clock_mhz * 1e6)
