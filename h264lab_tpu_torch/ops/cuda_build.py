"""Build of the port's hand-written CUDA kernels and their launch counts.

Each kernel is one source `csrc/<name>.cu` with a plain C interface. It is
compiled with nvcc for sm_90a into `_build/libh264lab_<name>_<digest>.so`
at first use, once per version of the source, and loaded with ctypes by
its wrapper's `Library` (`ops/bitpack.py` for K1, `ops/deblock.py` for
K2, `ops/wavefront.py` for K3, `ops/me.py` for K4 and K5,
`ops/symbolize.py` for K6, `ops/residual.py` for K7 and K8,
`ops/resample.py` for K9 and K10, `ops/refplanes.py` for K11,
`ops/pretile.py` for K12, `ops/denoise.py` for K13). A source
may include the headers beside it (`csrc/*.h`); the digest covers them.
Nothing is built when a module is imported: the CPU paths never need nvcc.

The mesh's shards launch the kernels from one worker thread each
(`parallel/gop.py`), so the first use may come from several threads at
once: `Library` builds and loads under a lock, and `count_launch` counts
under one.

The wrappers of K6 to K13 share their host-side code here, which sets
their host time a call on one frame: `pointers` checks the inputs in one
pass against specs worked out once per size (and `refuse` says what is
wrong), `buffer_plan` lays the outputs out in one buffer once per size,
`buffer_views` cuts it, and `call` hands a kernel its arguments as one
array of 64-bit words and checks its return code.
"""

from __future__ import annotations

import array
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# launches of each kernel wrapper; a run sets them to 0 and reads them to
# show that its main path went through the kernels
LAUNCH_COUNTS = {"bitpack": 0, "deblock": 0, "wavefront": 0, "me": 0,
                 "partition": 0, "symbolize": 0, "inter_residual": 0,
                 "select_parallel": 0, "resample_down": 0,
                 "resample_up": 0, "refplanes": 0, "pad_tiles": 0,
                 "denoise": 0}
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


# --- the wrappers' host side ------------------------------------------------

_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_current_card = getattr(torch._C, "_cuda_getDevice", None)


def stream_of(index: int) -> int:
    """The address of card `index`'s current CUDA stream."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def aligned16(tensor):
    """`tensor` contiguous and 16-byte aligned, as the kernels that
    bulk-copy their inputs take it (K10, K11): itself where it is, else a
    copy."""
    tensor = tensor.contiguous()
    return tensor if tensor.data_ptr() % 16 == 0 else tensor.clone()


def card_of(what: str, x) -> int:
    """The index of the CUDA device of `x`; raises for anything else."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{what} takes tensors on one CUDA device, not "
                         f"{getattr(x, 'device', type(x).__name__)}")
    return x.get_device()


def pointers(what: str, tensors, specs, index: int) -> list:
    """The inputs' addresses when the kernel takes every one of them:
    `specs` gives each one's (name, dtype, shape, alignment mask), worked
    out once per size by the caller; a tensor of that dtype and shape,
    contiguous, on card `index`, its address clear of the mask. One pass;
    `refuse` raises for the first input it does not take."""
    ptrs = []
    if len(tensors) == len(specs):
        try:
            for x, (_, dtype, shape, mask) in zip(tensors, specs):
                if x.dtype is not dtype or x.shape != shape \
                        or x.get_device() != index or not x.is_contiguous():
                    break
                p = x.data_ptr()
                if p & mask:
                    break
                ptrs.append(p)
            else:
                return ptrs
        except AttributeError:
            pass
    refuse(what, tensors, specs, index)


def refuse(what: str, tensors, specs, index: int):
    """Raise for the first input `pointers` does not take: ValueError for
    a count, device, shape, layout or alignment, TypeError for a dtype."""
    if len(tensors) != len(specs):
        raise ValueError(f"{what}: {len(tensors)} tensors, not {len(specs)}")
    for x, (name, dtype, shape, mask) in zip(tensors, specs):
        if not isinstance(x, torch.Tensor) or x.get_device() != index:
            raise ValueError(f"{what}: {name} is not a tensor on "
                             f"cuda:{index} ({getattr(x, 'device', x)!r})")
        if x.dtype is not dtype:
            raise TypeError(f"{what}: {name} is {x.dtype}, not {dtype}")
        if x.shape != shape:
            raise ValueError(f"{what}: {name} of shape {tuple(x.shape)}, "
                             f"not {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if x.data_ptr() & mask:
            raise ValueError(f"{what}: {name} is not {mask + 1}-byte "
                             "aligned")
    raise AssertionError(f"{what}: an input was refused, then taken")


@functools.lru_cache(maxsize=128)
def buffer_plan(layout: tuple):
    """One buffer for outputs laid out as `layout`, ((name, dtype,
    shape), ...) in order: its bytes, each output's (name, dtype, shape,
    strides, offset in elements of its dtype) and {name: byte offset},
    each output starting on a 16-byte boundary. Worked out once per
    layout."""
    views, offsets, at = [], {}, 0
    for name, dtype, shape in layout:
        shape = tuple(int(v) for v in shape)
        size = torch.empty((), dtype=dtype).element_size()
        strides, step = [], 1
        for v in reversed(shape):
            strides.append(step)
            step *= v
        views.append((name, dtype, shape, tuple(reversed(strides)),
                      at // size))
        offsets[name] = at
        at += -(-step * size // 16) * 16
    return at, tuple(views), offsets


def buffer_views(buf, views) -> dict:
    """The outputs as views of the one uint8 buffer (`buffer_plan`'s
    views, or some of them)."""
    by_dtype = {torch.uint8: buf}
    out = {}
    for name, dtype, shape, strides, off in views:
        b = by_dtype.get(dtype)
        if b is None:
            b = by_dtype[dtype] = buf.view(dtype)
        out[name] = b.as_strided(shape, strides, off)
    return out


def call(fn, words, what: str, index: int):
    """Call a kernel's entry point on card `index` with its arguments as
    one array of 64-bit words (addresses, sizes, flags, the stream); raise
    if it returned a CUDA error."""
    w = array.array("q", words)
    here = (_current_card() if _current_card is not None
            else torch.cuda.current_device())
    if here == index:
        rc = fn(w.buffer_info()[0])
    else:
        with torch.cuda.device(index):
            rc = fn(w.buffer_info()[0])
    check(rc, what)
