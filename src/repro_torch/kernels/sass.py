"""The dependent chain of a kernel's main loop, read from its SASS.

    python -m repro_torch.kernels.sass LIB.so [--match TEXT]

runs ``cuobjdump -sass`` on a built kernel library (``build/repro_torch/``)
and prints, for each function whose demangled name holds ``TEXT``, its
largest loop: the instructions of its body, and the longest chain of
register dependences that one iteration puts between a value the loop
carries and that value's next version.  A step of a latency-bound loop
cannot be shorter than that chain.

The count is static.  Every instruction counts one, whatever its latency.
Where the body branches, a register's depth after the join is the deepest
over the joining paths, so the chain is the longest over all paths through
one iteration (the kinds a kernel branches on included); an indirect
jump (a jump table) may reach any later block of the body; a call (a
division's slow path) counts as one instruction.  A predicated write
depends on the register's earlier value too.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Instr", "functions", "loop_chain", "main"]

_LINE = re.compile(r"^\s*/\*([0-9a-fA-F]+)\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L[\w.]*):")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_REG = re.compile(r"(?<![\w.])(U?R\d+|U?P\d+)(\.64)?(?![\w])")
_TYPES = re.compile(r"^[FSU](8|16|32|64)$")
# opcodes with no register result
_NO_DEST = ("ST", "STS", "STG", "STL", "RED", "REDG", "BRA", "BRX", "JMP",
            "EXIT", "RET", "CALL", "BSSY", "BSYNC", "WARPSYNC", "BAR", "NOP",
            "MEMBAR", "DEPBAR", "YIELD", "ERRBAR", "CCTL", "BPT", "KILL")
_FP64 = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "MUFU")
_BRANCHES = ("BRA", "BRX", "JMP")


@dataclass
class Instr:
    addr: int
    guard: Optional[str]  # "P0", "!P0", ... or None
    opcode: str
    operands: List[str]
    target: Optional[int] = None  # a branch's target address
    srcs: List[str] = field(default_factory=list)
    dests: List[str] = field(default_factory=list)

    @property
    def root(self) -> str:
        return self.opcode.split(".")[0]

    @property
    def always(self) -> bool:
        return self.guard in (None, "PT")

    @property
    def jumps_always(self) -> bool:
        """An unconditional jump: no guard, and no condition operand (as in
        ``BRA.U !UP0, target``)."""
        return self.always and len(self.operands) == 1


def _regs(text: str, width: int) -> List[str]:
    out = []
    for name, wide in _REG.findall(text):
        w = 2 if wide else width
        kind, num = re.match(r"(U?[RP])(\d+)", name).groups()
        if kind.endswith("P"):
            w = 1
        out += [f"{kind}{int(num) + k}" for k in range(w)]
    return out


def _widths(ins: Instr) -> Tuple[int, List[int]]:
    """(dest width, per-operand source widths) in 32-bit registers."""
    parts = ins.opcode.split(".")
    n = len(ins.operands)
    if ins.root in ("DADD", "DMUL", "DFMA", "DMNMX", "DSETP"):
        return 2, [2] * n
    if ins.root in ("F2F", "I2F", "F2I", "I2I", "I2FP", "F2IP"):
        types = [int(p[1:]) for p in parts[1:] if _TYPES.match(p)]
        dw = 2 if types and types[0] == 64 else 1
        sw = 2 if len(types) > 1 and types[1] == 64 else 1
        return dw, [sw] * n
    if ins.root == "IMAD" and "WIDE" in parts:
        return 2, [1, 1, 1, 2][:n] + [1] * max(0, n - 4)
    if "128" in parts:
        return 4, [4] * n
    if "64" in parts:
        return 2, [2] * n
    return 1, [1] * n


def _classify(ins: Instr) -> None:
    dw, sws = _widths(ins)
    srcs, dests = [], []
    if ins.guard not in (None, "PT", "!PT"):
        srcs += _regs(ins.guard, 1)
    ops = ins.operands
    if ins.root in _NO_DEST:
        n_dest = 0
    elif ins.root in ("PLOP3", "UPLOP3", "SHFL"):
        n_dest = 2
    else:
        n_dest = 1
        while (n_dest < len(ops)
               and re.fullmatch(r"U?P(\d+|T)", ops[n_dest].strip())):
            n_dest += 1
    for k, op in enumerate(ops):
        inner = "[" in op
        if k < n_dest and not inner:
            dests += _regs(op, dw)
        else:
            # an address is 32 bits unless marked .64; a load's data width
            # is its dest's
            srcs += _regs(op, 1 if inner else sws[k] if k < len(sws) else 1)
    if not ins.always:
        srcs += dests  # a predicated write keeps the old value
    ins.srcs, ins.dests = srcs, dests


def functions(sass: str) -> Dict[str, List[Instr]]:
    """Parse ``cuobjdump -sass`` output: function name -> instructions,
    branch targets resolved to addresses."""
    out: Dict[str, List[Instr]] = {}
    cur: Optional[List[Instr]] = None
    labels: Dict[str, int] = {}
    pending: List[str] = []
    fixups: List[Tuple[Instr, str]] = []

    def close():
        for ins, lab in fixups:
            ins.target = labels.get(lab)
        fixups.clear()
        labels.clear()

    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            close()
            cur = out.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _LINE.match(line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2).strip()
        for lab in pending:
            labels[lab] = addr
        pending.clear()
        guard = None
        if text.startswith("@"):
            guard, text = text[1:].split(None, 1)
        opcode, _, rest = text.partition(" ")
        operands = [o.strip() for o in rest.split(",")] if rest.strip() else []
        ins = Instr(addr, guard, opcode, operands)
        if ins.root in _BRANCHES and operands:
            t = operands[-1]
            lab = re.search(r"\((\.L[\w.]*)\)", t)
            if lab:
                fixups.append((ins, lab.group(1)))
            elif re.fullmatch(r"0x[0-9a-fA-F]+", t):
                ins.target = int(t, 16)
        _classify(ins)
        cur.append(ins)
    close()
    return out


def _blocks(body: List[Instr]) -> List[Tuple[int, int]]:
    addrs = {ins.addr: k for k, ins in enumerate(body)}
    lead = {0}
    for k, ins in enumerate(body):
        if ins.root in _BRANCHES or ins.root in ("EXIT", "RET"):
            lead.add(k + 1)
        if ins.target in addrs:
            lead.add(addrs[ins.target])
    lead = sorted(x for x in lead if x < len(body))
    return [(a, b) for a, b in zip(lead, lead[1:] + [len(body)])]


def loop_chain(instrs: List[Instr]) -> Optional[dict]:
    """The outermost loop of a function (the earliest target of a backward
    branch, up to the last branch back to it; blocks the compiler moved
    past that branch are left out): its body's instruction count, the
    chain (see the module's note) and the opcodes along it; None if there
    is no loop."""
    addrs = {ins.addr: k for k, ins in enumerate(instrs)}
    back = [(addrs[ins.target], k) for k, ins in enumerate(instrs)
            if ins.target in addrs and addrs[ins.target] <= k]
    if not back:
        return None
    h = min(t for t, _ in back)
    b = max(k for t, k in back if t == h)
    body = instrs[h:b + 1]
    head_addr = body[0].addr
    index = {ins.addr: k for k, ins in enumerate(body)}
    blocks = _blocks(body)
    start = {a: n for n, (a, _) in enumerate(blocks)}
    succ: List[List[int]] = []  # block -> successors; -1 is the back edge
    for a, e in blocks:
        last = body[e - 1]
        s = []
        if last.root in _BRANCHES and last.target is not None:
            if last.target == head_addr:
                s.append(-1)
            elif last.target in index and index[last.target] > e - 1:
                s.append(start[index[last.target]])
        falls = not ((last.root in _BRANCHES and last.jumps_always)
                     or (last.root in ("EXIT", "RET") and last.always))
        if falls and e < len(body):
            s.append(start[e])
        if last.root == "BRX":  # a jump table: any later block
            s = list(range(len(succ) + 1, len(blocks)))
        succ.append(s)

    # registers live at the loop head: read before written on some path
    live_in = [set() for _ in blocks]
    changed = True
    while changed:
        changed = False
        for n in reversed(range(len(blocks))):
            a, e = blocks[n]
            live = set()
            for s in succ[n]:
                live |= live_in[0 if s == -1 else s]
            for ins in reversed(body[a:e]):
                if ins.always:
                    live -= set(ins.dests)
                live |= set(ins.srcs)
            if live != live_in[n]:
                live_in[n], changed = live, True
    carried = live_in[0]

    # forward: each register's deepest (depth, writer) over joining paths
    state_in: List[Dict[str, Tuple[int, int]]] = [dict() for _ in blocks]
    reached = [n == 0 for n in range(len(blocks))]
    crit: Dict[int, int] = {}
    at_back: Dict[str, Tuple[int, int]] = {}  # what the back edge carries
    for n, (a, e) in enumerate(blocks):
        if not reached[n]:
            continue
        st = dict(state_in[n])
        for k in range(a, e):
            ins = body[k]
            d, src = 0, -1
            for r in ins.srcs:
                got = st.get(r)
                if got and got[0] > d:
                    d, src = got
            crit[k] = src
            for r in ins.dests:
                st[r] = (d + 1, k)
        for s in succ[n]:
            tgt = at_back if s == -1 else state_in[s]
            if s != -1:
                reached[s] = True
            for r, v in st.items():
                if r not in tgt or v[0] > tgt[r][0]:
                    tgt[r] = v
    chain, end = 0, -1
    for r in sorted(carried):  # ties: the first register by name
        if r in at_back and at_back[r][0] > chain:
            chain, end = at_back[r]
    path = []
    while end >= 0:
        path.append(body[end])
        end = crit.get(end, -1)
    path.reverse()
    ops = Counter(ins.root for ins in path)
    return {"body": len(body), "chain": chain,
            "chain_fp64": sum(v for k, v in ops.items() if k in _FP64),
            "chain_ops": dict(ops.most_common()),
            "body_fp64": sum(1 for ins in body if ins.root in _FP64)}


def _demangle(names: List[str]) -> Dict[str, str]:
    # c++filt first: cu++filt writes template arguments as "(int)2"
    tool = (shutil.which("c++filt") or shutil.which("cu++filt")
            or shutil.which("/usr/local/cuda/bin/cu++filt"))
    if tool is None:
        return {n: n for n in names}
    got = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, got)) if len(got) == len(names) else {
        n: n for n in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("lib", help="a built kernel library (.so)")
    ap.add_argument("--match", default="", help="part of a demangled name")
    args = ap.parse_args(argv)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", args.lib], capture_output=True,
                          text=True, check=True).stdout
    funcs = functions(sass)
    names = _demangle(list(funcs))
    for mangled, instrs in funcs.items():
        name = names[mangled].replace("repro_torch::(anonymous namespace)::",
                                      "").split("(")[0]
        if args.match not in name:
            continue
        rep = loop_chain(instrs)
        if rep is None:
            print(f"[sass] {name}: no loop")
            continue
        print(f"[sass] {name}: loop body {rep['body']} instructions "
              f"({rep['body_fp64']} FP64 or MUFU), chain {rep['chain']} "
              f"dependent instructions ({rep['chain_fp64']} FP64 or MUFU): "
              f"{rep['chain_ops']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
