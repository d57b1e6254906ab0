#!/usr/bin/env python3
"""Compare the SASS of one CUDA source between this checkout and another.

Builds ``src/repro_torch/kernels/csrc/<name>.cu`` from both trees with the
port's nvcc flags (``kernels/_build.py``) into a temporary directory,
disassembles both with ``cuobjdump -sass`` and prints, for each kernel
instance (keyed by its template arguments, so a changed parameter list
does not hide a match), its instruction count in each build and how many
instructions differ.  Needs the CUDA toolkit:

    python3 tools/sass_diff.py flash_attn_tf32 /path/to/other/checkout
"""
from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402


def kernel_key(mangled: str) -> str:
    """``name<args>`` of a mangled kernel: the last identifier of its nested
    name (not the file's anonymous namespace) and its integer and bool
    template arguments, if any (``p2p_kernel<8,16,16,1,0>``)."""
    i, ids = (3 if mangled.startswith("_ZN") else 2), []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        ids.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[i:])
    name = ids[-1] if ids else mangled
    if not args:
        return name
    return f"{name}<{','.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>"


def sass(so: Path) -> dict[str, list[str]]:
    """Instructions of each kernel in ``so``, keyed by the kernel's name and
    template arguments (``flash_attn_tf32_kernel<256>``), addresses dropped."""
    out = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass", str(so)],
                         capture_output=True, text=True, check=True).stdout
    funcs: dict[str, list[str]] = {}
    cur = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = kernel_key(m.group(1))
            funcs[cur] = []
            continue
        if cur is not None and "/*" in line:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split(";")[0].strip()
            if ins and not ins.startswith("/*"):
                funcs[cur].append(ins)
    return funcs


def build(root: Path, name: str, so: Path) -> Path:
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(root / "src/repro_torch/kernels/csrc" / f"{name}.cu")],
                   check=True, capture_output=True, text=True)
    return so


def main() -> None:
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    name, other = sys.argv[1], Path(sys.argv[2]).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        here = sass(build(ROOT, name, Path(tmp) / "here.so"))
        there = sass(build(other, name, Path(tmp) / "there.so"))
    for kernel in sorted(set(here) | set(there)):
        a, b = here.get(kernel), there.get(kernel)
        if a is None or b is None:
            print(f"{kernel}: only in {'this checkout' if b is None else other}")
            continue
        differ = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        print(f"{kernel}: {len(a)} instructions here, {len(b)} there, {differ} differ")


if __name__ == "__main__":
    main()
