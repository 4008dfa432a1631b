"""Registers a thread and spills of each kernel in the port's CUDA sources, as
``nvcc -Xptxas -v`` reports them with the build's own flags (sm_90a). Run
from the root of a checkout, on a machine with the CUDA toolkit:

    python3 tools/ptxas_report.py [--src PATH] [--match TEXT] [FILE ...]

FILE names sources under ``<src>/repro_torch/csrc`` (by default
``flash_attn.cu`` and ``flash_attn_bwd.cu``); they compile at the same time,
each once. ``--src`` is the ``src`` directory of the tree to report on (by
default this checkout's). ``--match`` keeps the kernels whose name holds it.
Each line printed is one JSON object: the file, the kernel's name with its
template arguments, its registers a thread, and its spill stores and loads
in bytes.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def demangle(name: str) -> str:
    """The kernel's C++ name, without its parameter list (the mangled name
    where ``c++filt`` is missing)."""
    if shutil.which("c++filt") is None:
        return name
    full = subprocess.run(["c++filt", name], capture_output=True, text=True).stdout.strip()
    return re.sub(r"^void |\(.*$", "", full.replace("(anonymous namespace)::", ""))


def report(text: str) -> list[dict]:
    """One entry a kernel from ptxas's verbose output."""
    rows, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name, spill = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)), int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            rows.append({"kernel": demangle(name), "registers": int(m.group(1)),
                         "spill_stores": spill[0], "spill_loads": spill[1]})
            name = None
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="*", default=["flash_attn.cu", "flash_attn_bwd.cu"])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--match", default="", help="keep the kernels whose name holds this")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _lib

    csrc = Path(args.src).resolve() / "repro_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        procs = {f: subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(csrc / f), "-o",
             str(Path(tmp) / (Path(f).stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for f in args.files}
        failed = False
        for f, p in procs.items():
            out, _ = p.communicate()
            if p.returncode:
                print(f"ptxas_report: {f} did not compile:\n{out[-4000:]}", file=sys.stderr)
                failed = True
                continue
            for row in report(out):
                if args.match in row["kernel"]:
                    print(json.dumps({"file": f, **row}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
