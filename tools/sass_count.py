#!/usr/bin/env python3
"""Count the SASS instructions of the port's CUDA kernels.

    python3 tools/sass_count.py SRC.cu [SRC.cu ...] [--match NAME]
                                [--dump DIR]

Each source is compiled with the flags of ``repro_torch/kernels/build.py``
(``sm_90a``, ``-O3``, ``-Xptxas -v``) into a cubin, whose SASS
``cuobjdump -sass`` prints.  For every kernel whose name contains
``--match`` it prints one JSON line: the registers, stack frame and
spills ptxas reports, the static instruction count, the count by opcode (the part
before the first dot: ``FADD``, ``FMUL``, ``LDG``, ``LDS``, ...), and every
loop (a branch back to an earlier address) with its instruction count and
opcodes, innermost first.  ``--dump DIR`` also writes each kernel's SASS
there.  Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit).
"""
import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xptxas", "-v")
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
BRANCH = re.compile(r"\b(?:BRA|BRX)\b.*?(0x[0-9a-f]+)")


def tool(name):
    found = shutil.which(name)
    if found:
        return found
    path = f"/usr/local/cuda/bin/{name}"
    if os.path.exists(path):
        return path
    sys.exit(f"{name} not found on PATH or under /usr/local/cuda/bin")


def ptxas_report(text):
    """{mangled kernel name: {"registers": r, "stack_frame": f,
    "spill_stores": s, "spill_loads": l}} from nvcc's -Xptxas -v output
    (a stack frame is local memory: an array the compiler could not keep
    in registers)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            out[name]["stack_frame"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def functions(sass):
    """{mangled name: [(address, opcode, operands)]} from cuobjdump -sass."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = INSTR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def opcodes(instrs):
    c = collections.Counter(op.split(".")[0] for _, op, _ in instrs)
    return dict(sorted(c.items(), key=lambda kv: -kv[1]))


def loops(instrs):
    """Each backward branch as a loop: its body from the target to the
    branch, innermost (smallest) first."""
    found = []
    for k, (addr, op, rest) in enumerate(instrs):
        m = BRANCH.search(op + rest)
        if not m or int(m.group(1), 16) >= addr:
            continue
        target = int(m.group(1), 16)
        body = [ins for ins in instrs if target <= ins[0] <= addr]
        found.append({"from": hex(target), "to": hex(addr),
                      "instructions": len(body), "opcodes": opcodes(body)})
    return sorted(found, key=lambda lp: lp["instructions"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--match", default="")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()
    nvcc, cuobjdump = tool("nvcc"), tool("cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        for k, src in enumerate(args.sources):
            cubin = os.path.join(tmp, f"{k}.cubin")
            res = subprocess.run([nvcc, *FLAGS, "-cubin", "-o", cubin, src],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                sys.exit(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
            regs = ptxas_report(res.stdout + res.stderr)
            sass = subprocess.run([cuobjdump, "-sass", cubin],
                                  capture_output=True, text=True,
                                  check=True).stdout
            for name, instrs in functions(sass).items():
                if args.match not in name:
                    continue
                if args.dump:
                    os.makedirs(args.dump, exist_ok=True)
                    with open(os.path.join(args.dump, f"{k}_{name}.sass"),
                              "w") as fh:
                        fh.writelines(f"{a:06x} {op}{rest}\n"
                                      for a, op, rest in instrs)
                print(json.dumps({"source": src, "kernel": name,
                                  **regs.get(name, {}),
                                  "instructions": len(instrs),
                                  "opcodes": opcodes(instrs),
                                  "loops": loops(instrs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
