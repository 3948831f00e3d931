#!/usr/bin/env python3
"""Whether two csrc/ directories compile a source's kernels to the same
code.

    python3 tools/same_code.py OLD_CSRC NEW_CSRC SOURCE [SOURCE ...]

Builds each SOURCE (a file name, e.g. flash_fwd.cu) of both directories
with the library's nvcc flags (ops/_build.py's, -Xptxas=-v among them), one
nvcc process a build, all at once, into
flashattention_kernel_project_tpu_torch/build/same/. Then it pairs the
kernels of OLD and NEW by name and integer template arguments: the same
symbol, or a NEW kernel whose arguments are an OLD one's followed by zeros
(a template parameter appended whose value 0 is the old behaviour, e.g.
kPlain). For each pair it prints whether ptxas's lines (registers,
barriers, shared and constant memory, stack frame, spills; the symbols
taken out) and the SASS (cuobjdump -sass, the function's instructions) are
identical. Exits 1 if a pair differs or an OLD kernel has no pair; the NEW
kernels without a pair (new instances) are listed.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def key(sym: str):
    """(kernel name, its integer template arguments, the rest of the
    mangled symbol)."""
    name, rest = cs.mangled_name(sym)
    return name, tuple(int(a) for a in re.findall(r"L[ib](\d+)E", rest)), rest


def _norm(text: str) -> str:
    """text with the per-file hashes of internal symbols taken out (they
    follow the source's path)."""
    return re.sub(r"_INTERNAL_[0-9a-f]+_", "_INTERNAL_", text)


def ptxas_lines(log: str) -> dict:
    """{symbol: ptxas's lines about it (its properties, stack frame and
    spills, registers and memory), the symbol taken out}."""
    out, current, own = {}, None, False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        props = re.search(r"Function properties for (\S+)", line)
        if m:
            current, own = m.group(1), False
            out[current] = []
        elif current is None:
            continue
        elif props:
            own = props.group(1) == current
            if own:
                out[current].append("properties")
        elif own and line.startswith("    "):
            out[current].append(line.strip())
        elif "Used" in line and "registers" in line:
            out[current].append(line.split(":", 1)[1].strip())
    return out


def sass(tool: str, obj: str) -> dict:
    """{symbol: its SASS, the symbol and internal hashes taken out}."""
    text = subprocess.run([tool, "-sass", obj], check=True, capture_output=True,
                          text=True, timeout=600).stdout
    out = {}
    for section in text.split("Function : ")[1:]:
        sym, body = section.split("\n", 1)
        sym = sym.strip()
        body = _norm(body.replace(sym, "<sym>").split("\n\t\t..........", 1)[0])
        out[sym] = "\n".join(" ".join(line.split()) for line in body.splitlines()
                             if line.strip())
    return out


def _opcodes(code: str) -> list:
    """The instructions of a SASS listing without their addresses,
    encodings and branch targets."""
    out = []
    for line in code.splitlines():
        m = re.match(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if m:
            out.append(re.sub(r"0x[0-9a-f]+", "0x", m.group(1)))
    return out


def first_difference(old: str, new: str) -> str:
    """Where two SASS listings part: their instruction counts, whether they
    match with addresses and branch targets taken out, the opcodes whose
    counts differ and the first differing instruction."""
    a, b = _opcodes(old), _opcodes(new)
    hist = {}
    for sign, ins in ((-1, a), (1, b)):
        for x in ins:
            op = x.lstrip("@!P0123456789T ").split(" ")[0]
            hist[op] = hist.get(op, 0) + sign
    moved = {op: n for op, n in hist.items() if n}
    first = next(((x, y) for x, y in zip(a, b) if x != y), None)
    return (f"{len(a)} and {len(b)} instructions; "
            f"{'the same up to addresses and targets' if a == b else 'they differ'}; "
            f"opcode counts new - old {dict(sorted(moved.items())[:12])}"
            + (f"; first: {first[0][:90]} | {first[1][:90]}" if first else ""))


def main() -> int:
    from flashattention_kernel_project_tpu_torch.ops import _build

    if len(sys.argv) < 4:
        raise SystemExit(__doc__)
    old_dir, new_dir, sources = (os.path.abspath(sys.argv[1]),
                                 os.path.abspath(sys.argv[2]), sys.argv[3:])
    out_dir = os.path.join(_build.BUILD_DIR, "same")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.nvcc()
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    jobs = {}
    for side, csrc in (("old", old_dir), ("new", new_dir)):
        for src in sources:
            obj = os.path.join(out_dir, f"{side}.{src}.o")
            jobs[(side, src)] = (obj, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-c", os.path.join(csrc, src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = 0
    for src in sources:
        found = {}
        for side in ("old", "new"):
            obj, proc = jobs[(side, src)]
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{side} {src}: build failed\n{log[-4000:]}")
            lines, code = ptxas_lines(log), sass(tool, obj)
            found[side] = {sym: (lines.get(sym, []), code[sym]) for sym in code}
        new_by_key = {key(sym): sym for sym in found["new"]}
        paired = set()
        for sym in sorted(found["old"]):
            name, args, rest = key(sym)
            match = sym if sym in found["new"] else next(
                (s for (n, a, _), s in new_by_key.items()
                 if n == name and len(a) > len(args) and a[:len(args)] == args
                 and not any(a[len(args):])), None)
            if match is None:
                print(f"{src}: {name}{args}: no kernel of NEW pairs with it")
                failed += 1
                continue
            paired.add(match)
            (old_lines, old_code), (new_lines, new_code) = (found["old"][sym],
                                                           found["new"][match])
            same_lines, same_code = old_lines == new_lines, old_code == new_code
            failed += not (same_lines and same_code)
            regs = next((ln for ln in new_lines if "registers" in ln), "")
            print(f"{src}: {name}{args} -> {key(match)[1]}: ptxas lines "
                  f"{'identical' if same_lines else 'DIFFER'}, SASS "
                  f"{'identical' if same_code else 'DIFFERS'} "
                  f"({len(new_code.splitlines())} lines; {regs})")
            if not same_lines:
                print("  old: " + " | ".join(old_lines) + "\n  new: " + " | ".join(new_lines))
            if not same_code:
                print("  " + first_difference(old_code, new_code))
        for sym in sorted(set(found["new"]) - paired):
            print(f"{src}: new instance {key(sym)[0]}{key(sym)[1]}: "
                  + " | ".join(found["new"][sym][0][1:]))
    print(f"{'all pairs identical' if not failed else f'{failed} pairs differ or lack a pair'}",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
