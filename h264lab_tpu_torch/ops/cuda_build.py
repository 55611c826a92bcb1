"""Build of the port's hand-written CUDA kernels and their launch counts.

Each kernel is one source `csrc/<name>.cu` with a plain C interface. It is
compiled with nvcc for sm_90a into `_build/libh264lab_<name>_<digest>.so`
at first use, once per version of the source, and loaded with ctypes by
its wrapper (`ops/bitpack.py` for K1, `ops/deblock.py` for K2,
`ops/wavefront.py` for K3, `ops/me.py` for K4 and K5). Nothing is built
when a module is imported: the CPU paths never need nvcc.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# launches of each kernel wrapper; a run sets them to 0 and reads them to
# show that its main path went through the kernels
LAUNCH_COUNTS = {"bitpack": 0, "deblock": 0, "wavefront": 0, "me": 0,
                 "partition": 0}


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libh264lab_{src.stem}_{digest}.so"


def build_all(srcs) -> list[tuple[Path, str]]:
    """Compile each source not yet built, one nvcc process per source, all
    started together. Returns [(library path, compiler log; empty if the
    library was cached)] in the order of `srcs`."""
    srcs = [Path(s) for s in srcs]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    jobs = []
    for src in srcs:
        out = _target(src)
        if out.exists():
            jobs.append((out, None, None))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((out, tmp, proc))
    # wait for every compiler before reporting a failure
    logs = [proc.communicate()[0] if proc else "" for _, _, proc in jobs]
    for src, (out, tmp, proc), log in zip(srcs, jobs, logs):
        if proc is not None and proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"({proc.returncode}):\n{log}")
    for out, tmp, proc in jobs:
        if proc is not None:
            os.replace(tmp, out)
    return [(out, log) for (out, _, _), log in zip(jobs, logs)]


def build(src) -> tuple[Path, str]:
    """`build_all` of one source."""
    return build_all([src])[0]


def check(rc: int, what: str):
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
