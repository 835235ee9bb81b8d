"""The loops of a built kernel's SASS, with their instruction counts.

    python -m scripts.sass_loops LIB.so KERNEL [--dump FILE.sass]

Run from the repository root. Runs `cuobjdump -sass` on LIB.so (a
library that `lidar_snow_sim_tpu_torch._kernels.build` made)
and takes the functions whose mangled name holds KERNEL (for instance
`a1_kernelILi32E`, A1 built for K <= 32, or `w1_kernel`). For each
function it prints one JSON line: its instruction count, its local-memory
loads and stores (LDL, STL: a kernel that keeps its state in registers and
shared memory has none), and its loops, found as backward branches.
A loop is [target, branch]; for each it gives the instructions in it, the
loops nested in it, and its count of FMUL, FADD, FSETP, LDS, LDG and
branch instructions. In the hit tests of csrc/occluders.cu every
(beam, column) test makes eight products (FMUL; the build has
-fmad=false), so a loop's tests an iteration are its FMUL count over 8.
Each loop also has its fast path: the fewest instructions one trip can
issue (branches taken or not as they allow), with its FMUL count; for a
hit-test loop that is the trip in which no column hits. `--dump` writes
the whole listing; LIB.so may also be such a listing (a `.sass` file),
which needs no cuobjdump. Otherwise it needs the CUDA toolkit's cuobjdump.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"Function : (\S+)")
_OPS = ("FMUL", "FADD", "FSETP", "LDS", "LDG", "BRA")
_LOCAL = ("LDL", "STL")   # local-memory loads and stores (spills, arrays)


def cuobjdump() -> str:
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        raise RuntimeError("cuobjdump not found")
    return exe


def functions(listing: str):
    """{mangled name: [(address, instruction text)]} of a SASS listing,
    with each `.L_x_N` label replaced by the address it marks."""
    out, labels, name, pending = {}, {}, None, []
    for line in listing.splitlines():
        m = _FUNC.search(line)
        if m:
            name, pending = m.group(1), []
            out[name], labels[name] = [], {}
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            out[name].append((addr, m.group(2)))
    return {n: [(a, _resolve(t, labels[n])) for a, t in instrs]
            for n, instrs in out.items()}


def _resolve(text: str, labels: dict) -> str:
    return re.sub(r"`\((\.L_x_\d+)\)", lambda m: hex(labels.get(m.group(1),
                                                                 -1)), text)


def _count(body, op):
    return sum(1 for _, t in body if re.search(rf"(^|\s){op}(\.|\s|$)", t))


def fast_path(body):
    """The fewest instructions one trip through a loop body can issue (its
    first to its last instruction, the back branch), and that path's
    instructions: a breadth-first walk in which a predicated branch may go
    either way, an unconditional one only to its target, and a branch out
    of the body ends nothing."""
    index = {a: i for i, (a, _) in enumerate(body)}
    prev, seen, queue = {0: None}, {0}, [0]
    while queue:
        nxt = []
        for i in queue:
            text = body[i][1]
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
            succ = []
            if not re.match(r"(BRA|JMP)(\.U)?\s+0x|EXIT|RET", text):
                succ.append(i + 1)
            if m and int(m.group(1), 16) in index and i != len(body) - 1:
                succ.append(index[int(m.group(1), 16)])
            for j in succ:
                if j < len(body) and j not in seen:
                    seen.add(j)
                    prev[j] = i
                    nxt.append(j)
        queue = nxt
    if len(body) - 1 not in prev:
        return []
    path, i = [], len(body) - 1
    while i is not None:
        path.append(body[i])
        i = prev[i]
    return path[::-1]


def loops(instrs):
    """The backward branches of one function as loops, innermost first."""
    addrs = [a for a, _ in instrs]
    found = []
    for i, (addr, text) in enumerate(instrs):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if not m:
            continue
        target = int(m.group(1), 16)
        if 0 <= target <= addr:
            lo = addrs.index(target) if target in addrs else None
            if lo is None:
                continue
            body = instrs[lo:i + 1]
            ops = {op: _count(body, op) for op in _OPS}
            fast = fast_path(body)
            found.append(dict(start=hex(target), end=hex(addr),
                              instructions=len(body), **ops,
                              fast_path=len(fast),
                              fast_path_fmul=_count(fast, "FMUL")))
    for lp in found:
        lo, hi = int(lp["start"], 16), int(lp["end"], 16)
        lp["nested"] = sum(1 for o in found if o is not lp
                           and lo <= int(o["start"], 16)
                           and int(o["end"], 16) <= hi)
    return sorted(found, key=lambda lp: lp["instructions"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("lib", type=Path)
    ap.add_argument("kernel")
    ap.add_argument("--dump", type=Path)
    args = ap.parse_args(argv)
    if args.lib.suffix == ".sass":   # a listing written by --dump
        listing = args.lib.read_text()
    else:
        listing = subprocess.run([cuobjdump(), "-sass", str(args.lib)],
                                 capture_output=True, text=True,
                                 check=True).stdout
    if args.dump:
        args.dump.write_text(listing)
    funcs = {n: f for n, f in functions(listing).items() if args.kernel in n}
    if not funcs:
        print(f"sass_loops: no function holds {args.kernel!r}",
              file=sys.stderr)
        return 1
    for name, instrs in funcs.items():
        print(json.dumps({"lib": args.lib.name, "function": name,
                          "instructions": len(instrs),
                          **{op: _count(instrs, op) for op in _LOCAL},
                          "loops": loops(instrs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
