#!/usr/bin/env python3
"""Count the machine instructions of compiled CUDA kernels by opcode.

    python3 scripts/sass_counts.py [PATH ...]   # from the repository root

Each PATH is a ``.cubin``, a shared library with embedded device code, or
a directory searched for both.  With no PATH it reads the port's built
libraries under ``build/kernels`` (``wsunet_tpu_torch/ops/_cuda_build``).
For every kernel it prints one JSON line: the file, the (mangled) kernel
name, its static instruction count, the count of each base opcode
(``LDG.E.U8.CONSTANT`` counts as ``LDG``), with the full opcodes of the
loads, stores and conversions beside them, and its innermost loops (the
code between a backward branch and its target, holding no other backward
branch), each with its instruction count and base-opcode mix.  The
counts are static: an instruction inside a loop counts once.

It runs ``cuobjdump -sass`` from the CUDA toolkit (``$CUDA_HOME/bin``,
``/usr/local/cuda/bin`` or ``PATH``), so it needs the toolkit but no card.
"""

import collections
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
# full opcodes are listed for these base opcodes
DETAIL = ("LDG", "LDS", "LDSM", "LDGSTS", "UBLKCP", "STG", "STS", "I2F",
          "I2FP", "F2F", "PRMT", "SHFL", "ATOM", "RED")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def find_cuobjdump() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "cuobjdump")):
            return os.path.join(home, "bin", "cuobjdump")
    tool = shutil.which("cuobjdump")
    if tool is None:
        raise SystemExit("cuobjdump not found ($CUDA_HOME/bin, "
                         "/usr/local/cuda/bin, PATH)")
    return tool


def listing(sass: str) -> dict:
    """Kernel name -> [(address, full opcode, branch target or None)],
    from cuobjdump's text."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if cur is not None and m:
            addr = int(re.search(r"/\*([0-9a-f]{4,})\*/", line).group(1), 16)
            bra = re.search(r"\bBRA(?:\.\w+)* (0x[0-9a-f]+)", line)
            cur.append((addr, m.group(1),
                        int(bra.group(1), 16) if bra else None))
    return out


def loops(ins: list) -> list:
    """The innermost loops of one kernel's listing: [(first address,
    instructions, Counter of base opcodes)]."""
    back = [(dst, src) for src, _, dst in ins if dst is not None and
            dst <= src]
    out = []
    for dst, src in back:
        if any(dst < d2 and s2 < src for d2, s2 in back):
            continue   # holds another loop
        body = [op for a, op, _ in ins if dst <= a <= src]
        out.append((dst, len(body), collections.Counter(
            op.split(".")[0] for op in body)))
    return out


def files(paths) -> list:
    found = []
    for p in map(pathlib.Path, paths):
        if p.is_dir():
            found += sorted(q for q in p.rglob("*")
                            if q.suffix in (".cubin", ".so"))
        else:
            found.append(p)
    return found


def main(argv) -> int:
    paths = argv or [str(REPO / "build" / "kernels")]
    tool = find_cuobjdump()
    targets = files(paths)
    if not targets:
        raise SystemExit(f"no .cubin or .so under {paths}")
    for f in targets:
        res = subprocess.run([tool, "-sass", str(f)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            print(json.dumps({"file": str(f), "error": res.stderr.strip()}))
            continue
        for kernel, ins in listing(res.stdout).items():
            ops = collections.Counter(op for _, op, _ in ins)
            base = collections.Counter()
            for op, n in ops.items():
                base[op.split(".")[0]] += n
            print(json.dumps({
                "file": str(f), "kernel": kernel,
                "instructions": sum(ops.values()),
                "base": dict(base.most_common()),
                "detail": {op: n for op, n in sorted(ops.items())
                           if op.split(".")[0] in DETAIL},
                "loops": [{"at": hex(at), "instructions": n,
                           "base": dict(mix.most_common())}
                          for at, n, mix in loops(ins)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
