"""Static instruction counts of the tensor-core kernels' instances, from
their SASS: each kernel source compiled alone for sm_90a with the build's
flags, `cuobjdump -sass` of the object, and for every instance whose
mangled name matches a pattern the instructions of its main loop (the
span of its outermost backward branch: one step, a whole column tile in
the one-chunk instances) counted by opcode.

    python3 tpu_knn_torch/probes/sass_counts.py [CHECKOUT] [OUT.json]
    python3 tpu_knn_torch/probes/sass_counts.py ptxas LOG_A LOG_B

CHECKOUT (default: this repo) is the tree whose tensor_kernels.cu and
tensor_ladder_kernels.cu are compiled, so two checkouts compare in one
chip call; with OUT.json, each file's SASS is written beside it
(OUT.json.<file>.sass.gz). Needs nvcc and cuobjdump (the CUDA toolkit);
prints one line an instance and, last, one JSON object of them. `ptxas`
compares two builds' ptxas reports (the .log beside each build's
library, tpu_knn_torch/_build/): every entry of both with its registers,
stack, spills and shared memory, the ones that differ or are in one
report only listed, and a last JSON line of the counts.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

#: (source under tpu_knn_torch/csrc, kernel-name pattern, label): B1's
#: CandidatesEpi and the ladder's v3 (AoS), B10 (TMA) and v6 (live rows)
#: instances.
KERNELS = [("tensor_kernels.cu", r"CandidatesEpi", "B1"),
           ("tensor_ladder_kernels.cu", r"tensor_aos_kernel", "v3"),
           ("tensor_ladder_kernels.cu", r"tensor_tma_kernel", "B10"),
           ("tensor_ladder_kernels.cu", r"tensor_live_kernel", "v6 live")]

#: The opcode classes reported apart (the rest sum under "other").
CLASSES = ("HMMA", "LDSM", "LDS", "STS", "LDGSTS", "UBLKCP", "SYNCS", "SHFL", "BAR", "FFMA",
           "FADD", "FMUL", "FSETP", "FSEL", "SEL", "F2FP", "PRMT", "IMAD", "IADD3", "ISETP",
           "LOP3", "LEA", "SHF", "MOV", "BRA")

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")
_LABEL = re.compile(r"^(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin",
                                                               "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def functions(sass: str):
    """{mangled name: [(address, opcode, operands, label or None)]}."""
    out, cur, label = {}, None, None
    for line in sass.splitlines():
        if m := _FUNC.match(line):
            cur = out.setdefault(m.group(1), [])
            continue
        if m := _LABEL.match(line.strip()):
            label = m.group(1)
            continue
        if cur is not None and (m := _INSN.match(line)):
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            op, _, rest = text.partition(" ")
            cur.append((int(m.group(1), 16), op, rest, label))
            label = None
    return out


def loop_counts(insns):
    """(instructions of the outermost loop by class, its total, the whole
    function's total): the span from the target of the backward branch that
    jumps farthest back to that branch (a label, or an address)."""
    at = {label: i for i, (_, _, _, label) in enumerate(insns) if label}
    at.update({addr: i for i, (addr, _, _, _) in enumerate(insns)})
    best = None
    for i, (_, op, rest, _) in enumerate(insns):
        t = _TARGET.search(rest) if op.startswith("BRA") else None
        j = t and at.get(t.group(1) or int(t.group(2), 16))
        if j is not None and j < i and (best is None or i - j > best[1] - best[0]):
            best = (j, i)
    span = insns[best[0]:best[1] + 1] if best else insns
    counts = collections.Counter()
    for _, op, _, _ in span:
        base = op.split(".")[0]
        counts[base if base in CLASSES else "other"] += 1
    return dict(counts), len(span), len(insns)


def ptxas_entries(path: str) -> dict:
    """{mangled entry: (its 'Function properties' and 'Used ...' lines)}
    from a ptxas -v report."""
    out, entry = {}, None
    with open(path) as fh:
        for line in fh:
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                entry = m.group(1)
                out[entry] = []
            elif entry and re.search(r"bytes stack frame|Used \d+ registers", line):
                out[entry].append(re.sub(r"\s+", " ", line.split(":", 1)[-1].strip()))
    return {e: tuple(v) for e, v in out.items()}


def compare_ptxas(log_a: str, log_b: str) -> int:
    a, b = ptxas_entries(log_a), ptxas_entries(log_b)
    # Entries are mangled with each translation unit's own hash: compare by
    # the name after it.
    key = lambda e: re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+", r"\1", e)  # noqa
    a, b = ({key(e): v for e, v in d.items()} for d in (a, b))
    same = [e for e in a if e in b and a[e] == b[e]]
    differ = [e for e in a if e in b and a[e] != b[e]]
    for e in differ:
        print(f"differs: {e}: {a[e]} -> {b[e]}")
    for e in sorted(set(a) ^ set(b)):
        print(f"only in {'A' if e in a else 'B'}: {e}: {a.get(e) or b.get(e)}")
    print(json.dumps({"same": len(same), "differ": len(differ), "only_a": len(set(a) - set(b)),
                      "only_b": len(set(b) - set(a))}))
    return 0


def main(argv) -> int:
    import gzip

    if argv[:1] == ["ptxas"] and len(argv) == 3:
        return compare_ptxas(argv[1], argv[2])
    repo = os.path.abspath(argv[0]) if argv else os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    csrc = os.path.join(repo, "tpu_knn_torch", "csrc")
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted({f for f, _, _ in KERNELS}):
            obj = os.path.join(tmp, src + ".o")
            subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                            "-O3", "-Xcompiler", "-fPIC", "-c", os.path.join(csrc, src), "-o",
                            obj], check=True)
            sass = subprocess.run([cuobjdump, "-sass", obj], check=True, capture_output=True,
                                  text=True).stdout
            if len(argv) > 1:  # the SASS itself beside OUT.json
                with gzip.open(f"{argv[1]}.{src}.sass.gz", "wt") as fh:
                    fh.write(sass)
            for name, insns in sorted(functions(sass).items()):
                for f, pattern, label in KERNELS:
                    if f == src and re.search(pattern, name):
                        counts, loop, total = loop_counts(insns)
                        result[name] = {"kernel": label, "loop": loop, "total": total,
                                        "classes": counts}
                        top = ", ".join(f"{op} {c}" for op, c in
                                        sorted(counts.items(), key=lambda x: -x[1]))
                        print(f"{label} {name}: loop {loop} of {total} instructions: {top}")
    if len(argv) > 1:
        with open(argv[1], "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({name: [v["kernel"], v["loop"], v["total"]] for name, v in result.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
