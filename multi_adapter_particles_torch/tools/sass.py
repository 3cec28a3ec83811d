"""SASS of the hand-written kernels: the instruction mix of their rsqrt
loops, and the ptxas register and spill lines.

    python -m multi_adapter_particles_torch.tools.sass SOURCE.cu [nvcc flag ...]
    python -m multi_adapter_particles_torch.tools.sass --dump KERNEL SOURCE.cu

compiles one source for sm_90a (`-cubin`, `-Xptxas -v`), disassembles it
with the toolkit's `cuobjdump -sass`, and prints, for each kernel, its
registers and spills and the instruction mix of each of its rsqrt loops
per MUFU.RSQ (one rsqrt a pair in the all-pairs kernels, so the counts
are per pair); `--dump` prints the SASS of one kernel's rsqrt loops.
Needs the CUDA toolkit (`nvcc`, `cuobjdump`); no GPU.

An rsqrt loop is the body of an innermost backward branch that holds a
MUFU.RSQ: a loop unrolled U times over R pairs holds U * R of them, and
every instruction in the body takes one issue slot whether its predicate
fires or not.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path
from typing import Sequence

FP32 = ("FFMA", "FADD", "FMUL")

_FUNC = re.compile(r"Function : (\S+)")
_INSTR = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def kernel_name(mangled: str) -> str:
    """A kernel's name and its template arguments (ints or bools) from its
    Itanium-mangled symbol: `_ZN12_GLOBAL__N_120sweep_n3_pair_kernelILi4E
    ...` -> `sweep_n3_pair_kernel<4>`, `..._kernelILb1ELb0ELb0EE...` ->
    `..._kernel<1,0,0>`."""
    s = mangled[2:].lstrip("N") if mangled.startswith("_Z") else mangled
    name = s
    while (m := re.match(r"\d+", s)):
        n, start = int(m.group()), m.end()
        name, s = s[start:start + n], s[start + n:]
    t = re.match(r"I((?:L[a-z]+-?\d+E)+)", s)
    if not t:
        return name
    return name + "<" + ",".join(re.findall(r"L[a-z]+(-?\d+)E",
                                           t.group(1))) + ">"


def _tool(name: str) -> str:
    from multi_adapter_particles_torch.ops import _build

    return os.path.join(os.path.dirname(_build.nvcc_path()), name)


def compile_cubin(source: Path, cubin: Path,
                  extra: Sequence[str] = ()) -> list[str]:
    """Compile `source` to `cubin` for sm_90a with `-Xptxas -v`; returns one
    line a kernel: its name, registers, then its spill line."""
    from multi_adapter_particles_torch.ops import _build

    cmd = [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", *extra, "-Xptxas", "-v", "-cubin",
           "-o", str(cubin), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -cubin {source}: {proc.stderr}")
    out, kernel, parts = [], "?", []
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = kernel_name(entry.group(1))
        elif "spill" in line:
            parts = [line.strip()]
        elif "registers" in line:
            out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}; "
                       + "; ".join(parts))
            parts = []
    return out


def disassemble(cubin: Path) -> dict[str, list[tuple]]:
    """`parse` of `cuobjdump -sass cubin`."""
    proc = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump: {proc.stderr}")
    return parse(proc.stdout)


def parse(text: str) -> dict[str, list[tuple]]:
    """{kernel: [(address, predicate, opcode, operands), ...]} of SASS
    text; branch targets given as labels become addresses."""
    kernels, labels, kernel, pending = {}, {}, None, []
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            kernel = kernel_name(m.group(1))
            kernels[kernel], labels[kernel], pending = [], {}, []
            continue
        if kernel is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[kernel][lab] = addr
            pending = []
            kernels[kernel].append((addr, (m.group(2) or "").strip(),
                                    m.group(3), m.group(4).strip()))
    for kernel, instrs in kernels.items():
        fixed = []
        for addr, pred, op, args in instrs:
            for lab, target in labels[kernel].items():
                args = args.replace(f"`({lab})", hex(target))
            fixed.append((addr, pred, op, args))
        kernels[kernel] = fixed
    return kernels


def _base(op: str) -> str:
    return op.split(".")[0]


def rsqrt_loops(instrs: list[tuple]) -> list[list[tuple]]:
    """The bodies of the innermost loops (backward branches) that hold a
    MUFU.RSQ, in address order: no other such loop lies inside one."""
    loops = []
    for k, (addr, _, op, args) in enumerate(instrs):
        if _base(op) != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", args)
        if not m or int(m.group(1), 16) > addr:
            continue
        body = [ins for ins in instrs[:k + 1]
                if ins[0] >= int(m.group(1), 16)]
        if any(ins[2].startswith("MUFU.RSQ") for ins in body):
            loops.append(body)
    span = [(b[0][0], b[-1][0]) for b in loops]
    return [b for b, (lo, hi) in zip(loops, span)
            if not any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                       for l2, h2 in span)]


def loop_mix(body: list[tuple]) -> dict:
    """Instruction classes of a loop body per MUFU.RSQ: FP32 (each of
    FP32), MUFU, SHFL, LDS, FSETP, the rest, and all of them (issue
    slots); `pairs` is the body's MUFU.RSQ count, `guarded` whether any
    FP32 instruction is predicated (the non-ftz rsqrt's denormal guard)."""
    pairs = sum(1 for ins in body if ins[2].startswith("MUFU.RSQ"))
    if not pairs:
        return {}
    c = Counter(_base(op) for _, _, op, _ in body)
    named = (*FP32, "MUFU", "SHFL", "LDS", "FSETP")
    mix = {k: c[k] / pairs for k in named}
    mix["fp32"] = sum(c[k] for k in FP32) / pairs
    mix["other"] = sum(v for k, v in c.items() if k not in named) / pairs
    mix["slots"] = len(body) / pairs
    mix["pairs"] = pairs
    mix["predicated_fp32"] = sum(1 for _, pred, op, _ in body
                                 if pred and _base(op) in FP32) / pairs
    # the compiler's fallback for shuffles it cannot prove warp-uniform:
    # a cold copy of the loop
    mix["collective"] = c["ENDCOLLECTIVE"] > 0
    mix["guarded"] = mix["predicated_fp32"] > 0
    mix["other_ops"] = dict(sorted((k, v) for k, v in c.items()
                                   if k not in named))
    return mix


def report(source: Path, extra: Sequence[str] = (),
           tmp: Path | None = None) -> tuple[list[str], dict[str, list]]:
    """(ptxas lines, {kernel: [mix of each rsqrt loop]}) of one source."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=tmp) as d:
        cubin = Path(d) / (source.stem + ".cubin")
        ptxas = compile_cubin(source, cubin, extra)
        mixes = {k: [loop_mix(b) for b in rsqrt_loops(v)]
                 for k, v in disassemble(cubin).items()}
    return ptxas, {k: v for k, v in mixes.items() if v}


def format_mix(mix: dict) -> str:
    return (f"{mix['slots']:.3f} issue slots a pair ({mix['pairs']} pairs "
            f"a body): FP32 {mix['fp32']:.3f} (FFMA {mix['FFMA']:.3f}, "
            f"FADD {mix['FADD']:.3f}, FMUL {mix['FMUL']:.3f}), MUFU "
            f"{mix['MUFU']:.3f}, SHFL {mix['SHFL']:.3f}, LDS {mix['LDS']:.3f}, "
            f"FSETP {mix['FSETP']:.3f}, other {mix['other']:.3f} "
            f"{mix['other_ops']}; predicated FP32 "
            f"{mix['predicated_fp32']:.3f}"
            + ("; the divergent-shuffle fallback" if mix["collective"]
               else ""))


def dump(source: Path, kernel: str, extra: Sequence[str] = ()) -> str:
    """The SASS text of `kernel`'s rsqrt loops in `source`."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        cubin = Path(d) / (source.stem + ".cubin")
        compile_cubin(source, cubin, extra)
        loops = rsqrt_loops(disassemble(cubin)[kernel])
    return "\n\n".join("\n".join(f"/*{a:04x}*/ {p} {op} {args};"
                                  for a, p, op, args in body)
                        for body in loops)


def main(argv) -> int:
    if not argv:
        raise SystemExit(__doc__)
    if argv[0] == "--dump":
        print(dump(Path(argv[2]), argv[1], tuple(argv[3:])))
        return 0
    ptxas, mixes = report(Path(argv[0]), tuple(argv[1:]))
    for line in ptxas:
        print("ptxas", line)
    for kernel, loops in mixes.items():
        for mix in loops:
            print(f"loop {kernel}: {format_mix(mix)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
