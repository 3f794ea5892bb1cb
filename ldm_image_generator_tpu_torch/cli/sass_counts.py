"""What the CUDA kernels compiled to, per kernel function: tensor-core
instructions (HMMA: mma.sync), fp32 FMAs on the CUDA cores (FFMA), and
ptxas's registers, stack frame and spill bytes from the build.

    python -m ldm_image_generator_tpu_torch.cli.sass_counts \
        [--sources ffn_block ffn_block_bwd ...]

Builds the listed sources (every one by default) and reads each library
with the CUDA toolkit's cuobjdump -sass. Prints one line per kernel:
HMMA, FFMA, registers, stack frame bytes, spill store/load bytes and the
demangled name.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

from ldm_image_generator_tpu_torch.kernels import _build


def _tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(f"{name} not found: it ships with the CUDA toolkit")


def sass_counts(sass: str) -> dict:
    """{mangled kernel name: (HMMA count, FFMA count)} of cuobjdump -sass
    output."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        out[name.strip()] = (len(re.findall(r"\bHMMA\b", body)),
                             len(re.findall(r"\bFFMA\b", body)))
    return out


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: (registers, stack frame bytes, spill store
    bytes, spill load bytes)} of an nvcc -Xptxas -v log."""
    out, name, spills = {}, None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0, 0)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spills = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spills)
            name = None
    return out


def demangle(names) -> dict:
    names = list(names)
    filt = shutil.which("c++filt")
    if not filt or not names:
        return {n: n for n in names}
    res = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, check=True)
    return dict(zip(names, res.stdout.splitlines()))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sources", nargs="+", default=list(_build.SOURCES),
                    choices=list(_build.SOURCES))
    args = ap.parse_args(argv)
    _build.build_all(args.sources)
    cuobjdump = _tool("cuobjdump")
    for src in args.sources:
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(src))],
                              capture_output=True, text=True, check=True).stdout
        counts = sass_counts(sass)
        regs = ptxas_report(_build.build_log(src))
        names = demangle(counts)
        for mangled, (hmma, ffma) in sorted(counts.items(), key=lambda kv: names[kv[0]]):
            r, frame, st, ld = regs.get(mangled, (-1, -1, -1, -1))
            print(f"{src}: {hmma:5d} HMMA {ffma:6d} FFMA {r:4d} registers "
                  f"stack {frame} B spill {st}/{ld} B  {names[mangled][:150]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
