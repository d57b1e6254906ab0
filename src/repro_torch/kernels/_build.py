"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/kernels/<name>-<hash>.so`` under the repository
root, where the hash covers the source, every ``csrc/*.cuh`` header and
the flags: a changed source or header builds anew, an unchanged one loads
the library already built.  All missing libraries compile at once, one
``nvcc`` process per source.  The
compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside each library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("p2p", "m2l", "leaf_expansions", "flash_attn", "flash_attn_tc",
           "flash_attn_tf32")
SMS = 132   # the H100's streaming multiprocessors: the range forms' cluster splits
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-DCARD_SMS={SMS}")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` that is missing, all in parallel.

    Returns ``{name: compiler report}``; raises with the report of each
    source that failed to compile.
    """
    pending = [n for n in names if not library_path(n).exists()]
    if pending:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        try:
            for name in pending:
                so = library_path(name)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, so)
            failed = []
            for name, (proc, tmp, so) in procs.items():
                report, _ = proc.communicate()
                so.with_suffix(".log").write_text(report)
                if proc.returncode:
                    failed.append(f"{name}.cu:\n{report}")
                else:
                    os.replace(tmp, so)   # atomic: a reader never sees half a file
        finally:
            for proc, _, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    reports = {}
    for name in names:
        log = library_path(name).with_suffix(".log")
        reports[name] = log.read_text() if log.exists() else ""
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
