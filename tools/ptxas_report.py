#!/usr/bin/env python3
"""Registers, spills and shared memory of every kernel instantiation of the
port's CUDA sources, as `nvcc -Xptxas -v` reports them.

    python3 tools/ptxas_report.py [--csrc DIR] [--label TEXT]

Compiles each `*.cu` of DIR (default `garden_tpu_torch/csrc`) with the
flags `garden_tpu_torch.cuda_build` uses, into a temporary directory, one
nvcc at a time, and prints one line per kernel: its demangled name,
registers, spill stores and loads (bytes), static shared memory (bytes)
and stack frame (bytes). Point --csrc at another checkout's sources to
report an older version beside the current one. Needs the CUDA toolkit.
"""

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from garden_tpu_torch import cuda_build  # noqa: E402


def demangle(names):
    tool = shutil.which("cu++filt") or str(Path(cuda_build.nvcc_path()).parent / "cu++filt")
    if not Path(tool).exists():
        tool = shutil.which("c++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if len(lines) == len(names) else list(names)


def report(src: Path, tmp: Path):
    """[(mangled name, registers, spill stores, spill loads, smem, stack)]."""
    cmd = [cuda_build.nvcc_path(), "-Xptxas=-v", *cuda_build.NVCC_FLAGS,
           "-o", str(tmp / (src.stem + ".so")), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    rows, name, frame = [], None, (0, 0, 0)
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), frame[1], frame[2],
                         int(m.group(2) or 0), frame[0]))
            name, frame = None, (0, 0, 0)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=cuda_build.CSRC)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(args.csrc.glob("*.cu")):
            rows = report(src, Path(tmp))
            for (name, regs, st, ld, smem, stack), pretty in zip(
                    rows, demangle([r[0] for r in rows])):
                print(f"ptxas {args.label} {src.name}: {pretty}: {regs} registers, "
                      f"spill stores {st} B, spill loads {ld} B, smem {smem} B, "
                      f"stack {stack} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
