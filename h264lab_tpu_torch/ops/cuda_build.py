"""Build of the port's hand-written CUDA kernels and their launch counts.

Each kernel is one source `csrc/<name>.cu` with a plain C interface. It is
compiled with nvcc for sm_90a into `_build/libh264lab_<name>_<digest>.so`
at first use, once per version of the source, and loaded with ctypes by
its wrapper's `Library` (`ops/bitpack.py` for K1, `ops/deblock.py` for
K2, `ops/wavefront.py` for K3, `ops/me.py` for K4 and K5,
`ops/symbolize.py` for K6, `ops/residual.py` for K7 and K8). A source
may include the headers beside it (`csrc/*.h`); the digest covers them.
Nothing is built when a module is imported: the CPU paths never need nvcc.

The mesh's shards launch the kernels from one worker thread each
(`parallel/gop.py`), so the first use may come from several threads at
once: `Library` builds and loads under a lock, and `count_launch` counts
under one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# launches of each kernel wrapper; a run sets them to 0 and reads them to
# show that its main path went through the kernels
LAUNCH_COUNTS = {"bitpack": 0, "deblock": 0, "wavefront": 0, "me": 0,
                 "partition": 0, "symbolize": 0, "inter_residual": 0,
                 "select_parallel": 0}
_COUNT_LOCK = threading.Lock()


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.h")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"libh264lab_{src.stem}_{digest}.so"


def _log_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".log")


def build_all(srcs) -> list[tuple[Path, str]]:
    """Compile each source not yet built, one nvcc process per source, all
    started together. Returns [(library path, compiler log)] in the order
    of `srcs`; a cached library's log is the one kept beside it when it
    was built."""
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
    for (out, tmp, proc), log in zip(jobs, logs):
        if proc is not None:
            _log_path(out).write_text(log)
            os.replace(tmp, out)
    return [(out, log if proc is not None else _read_log(out))
            for (out, _, proc), log in zip(jobs, logs)]


def _read_log(lib: Path) -> str:
    try:
        return _log_path(lib).read_text()
    except OSError:
        return ""


def build(src) -> tuple[Path, str]:
    """`build_all` of one source."""
    return build_all([src])[0]


def check(rc: int, what: str):
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def count_launch(name: str):
    """Add one to `LAUNCH_COUNTS[name]`; exact under concurrent launches."""
    with _COUNT_LOCK:
        LAUNCH_COUNTS[name] += 1


class Library:
    """The library of one kernel source: built (`build`) and loaded with
    its entry points' ctypes signatures, {name: (argtypes, restype)}, at
    the first call, once per process however many threads call at once.
    Calling it returns the loaded `ctypes.CDLL`."""

    def __init__(self, src, signatures: dict):
        self.src = Path(src)
        self.signatures = signatures
        self._handle = None
        self._lock = threading.Lock()

    def __call__(self) -> ctypes.CDLL:
        if self._handle is None:
            with self._lock:
                if self._handle is None:
                    self._handle = self.load(build(self.src)[0])
        return self._handle

    def load(self, path) -> ctypes.CDLL:
        """The library built at `path` with the entry points' signatures
        set."""
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in self.signatures.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        return lib

    def use(self, path) -> ctypes.CDLL:
        """Launch the library built at `path` (a copy of the source, such
        as an earlier tree's or one with clock stamps) from now on."""
        with self._lock:
            self._handle = self.load(path)
        return self._handle
