"""Design variants of K7 (`h264lab_tpu_torch/csrc/inter.cu`) and K8
(`csrc/select.cu`) against the kernels as they are, in turns on the CUDA
card, outputs equal.

    python tools/torch_k78_variants.py [--reps N]

Each variant is written from the current source into the gitignored
`h264lab_tpu_torch/_build/variants/` (with the headers beside it) and
built there:
- `K8 two launches`: ISSUE 21's design (a) for K8: a first launch
  (`select_want_kernel`, `wants_intra` once per MB) writes mode16 and a
  byte per MB, and the kernel, started by programmatic dependent launch
  (`cudaLaunchKernelEx` with programmatic stream serialization, and
  `griddepcontrol` in both kernels), reads its own and its neighbours'
  bytes after `griddepcontrol.wait` instead of recomputing its halo
  (design (b), the kernel as it is). The variant's byte buffer is a
  `cudaMalloc` of its own, kept across calls (a measuring variant only);
- `K7 windows through registers`: K7's chroma windows loaded word by
  word through registers (PR 21's first version) in place of its 4-byte
  asynchronous copies;
- `K7 at 4, 6 blocks an SM` and `K8 at 4, 5 blocks an SM`: other
  `__launch_bounds__` minimums than the source's (K7 5, K8 6), that is
  other register caps.

For each, on `chip_smoke.py`'s seeded 16-lane and one-frame cases, it
prints the wrapper's ms (CUDA events over `--reps` calls) in turns
(current, variant, variant, current, twice), each build's ptxas
registers and spills, and the device us of each kernel of one call
(`chip_smoke.kernel_launches`).

Needs a CUDA device; every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from h264lab_tpu_torch.models import mbscan  # noqa: E402
from h264lab_tpu_torch.ops import cuda_build, residual  # noqa: E402
from h264lab_tpu_torch.utils.device import card_label  # noqa: E402

VARIANTS_DIR = cuda_build.BUILD_DIR / "variants"


def _sub(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"variant anchor not found once: {old[:60]!r}")
    return text.replace(old, new)


def two_launches(src: str) -> str:
    """select.cu as design (a): a "wants intra" launch, then the kernel by
    programmatic dependent launch, reading the bytes."""
    a = src.index("__global__ void __launch_bounds__(kThreads, 6)\n"
                  "select_parallel_kernel")
    src = src[:a] + '''__global__ void __launch_bounds__(kThreads)
select_want_kernel(const Args a, uint8_t* want) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int g = threadIdx.x & 7;
  const long long kt = (long long)blockIdx.x * kTile + (threadIdx.x >> 3);
  const bool valid = kt < a.mbs;
  const long long k = valid ? kt : a.mbs - 1;
  int mode, l0, l1;
  uint4 top;
  const bool w = wants_intra(a, k, g, mode, top, l0, l1);
  if (g == 0 && valid) {
    a.mode16[k] = mode;
    want[k] = w;
  }
}

''' + src[a:]
    src = _sub(src, "select_parallel_kernel(const Args a) {",
               "select_parallel_kernel(const Args a, const uint8_t* wb) {")
    a = src.index('  // 2. "wants intra" of the tile\'s MBs')
    b = src.index("  // 3. the chroma edges of the MB")
    src = src[:a] + '''  int mode;
  {
    const bool up = b.m >= a.mbw, before = b.m >= 1;
    uint8_t* e = s.edge[t];
    if (g < 4)
      reinterpret_cast<uint32_t*>(e)[g] =
          up ? *reinterpret_cast<const uint32_t*>(
                   a.rec_y_i + 256 * (k - a.mbw) + 240 + 4 * g)
             : 0u;
    const uint8_t* ly = a.rec_y_i + 256 * (k - 1) + 32 * g + 15;
    e[16 + 2 * g] = before ? ly[0] : 0;
    e[17 + 2 * g] = before ? ly[16] : 0;
  }
''' + src[b:]
    a = src.index("  __syncthreads();                  // every group's wants")
    b = src.index("  const uint8_t* e = s.edge[t];\n  const uint32_t* etop")
    src = src[:a] + '''  asm volatile("griddepcontrol.wait;" ::: "memory");
  const bool i16 = __ldcg(wb + k)
                   && !(b.left && b.m >= 1 && __ldcg(wb + k - 1))
                   && !(b.top && b.m >= a.mbw && __ldcg(wb + k - a.mbw));
  mode = __ldcg(a.mode16 + k);
  __syncwarp();
''' + src[b:]
    a = src.index("  select_parallel_kernel<<<")
    b = src.index("  return (int)cudaGetLastError();\n}", a)
    return src[:a] + '''  static uint8_t* want = nullptr;
  static long long cap = 0;
  if (cap < mbs) {
    if (want) cudaFree(want);
    if (cudaMalloc(&want, mbs) != cudaSuccess) return (int)cudaGetLastError();
    cap = mbs;
  }
  const unsigned blocks = (unsigned)((mbs + kTile - 1) / kTile);
  cudaStream_t st = (cudaStream_t)p(41);
  select_want_kernel<<<blocks, kThreads, 0, st>>>(a, want);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, select_parallel_kernel, a,
                                            (const uint8_t*)want);
  if (rc != cudaSuccess) return (int)rc;
''' + src[b:]


def register_windows(src: str) -> str:
    """inter.cu with the chroma windows loaded through registers, word by
    word, in place of its asynchronous copies."""
    src = _sub(src, '''#pragma unroll
      for (int j = 0; j < 3; ++j)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                     :: "r"(tq_smem(to + j)), "l"(from + j) : "memory");''',
               '''      to[0] = from[0];
      to[1] = from[1];
      to[2] = from[2];''')
    return _sub(src, '''  asm volatile("cp.async.wait_all;" ::: "memory");
''', "")


def bounds(kernel_name, now, to):
    def edit(src):
        return _sub(src, f"__launch_bounds__(kThreads, {now})\n{kernel_name}",
                    f"__launch_bounds__(kThreads, {to})\n{kernel_name}")
    return edit


VARIANTS = (
    ("K8", "K8 two launches", two_launches, 2),
    ("K8", "K8 at 4 blocks an SM", bounds("select_parallel_kernel", 6, 4), 1),
    ("K8", "K8 at 5 blocks an SM", bounds("select_parallel_kernel", 6, 5), 1),
    ("K7", "K7 windows through registers", register_windows, 1),
    ("K7", "K7 at 4 blocks an SM", bounds("inter_residual_kernel", 5, 4), 1),
    ("K7", "K7 at 6 blocks an SM", bounds("inter_residual_kernel", 5, 6), 1),
)


def write_variant(src_path, tag, edit):
    """The edited source in its own directory of `VARIANTS_DIR`, with the
    headers beside it."""
    d = VARIANTS_DIR / tag.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    for h in cuda_build.CSRC.glob("*.h"):
        shutil.copy(h, d)
    out = d / os.path.basename(src_path)
    out.write_text(edit(open(src_path).read()))
    return out


def ptxas(log):
    return "; ".join(line.split("ptxas info    : ")[-1].strip()
                     for line in log.splitlines()
                     if "Used" in line or "spill" in line)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k78_variants: no CUDA device", file=sys.stderr)
        return 2
    label = f"[{card_label()}]"
    print(label)
    srcs = {"K7": residual.K7_SRC, "K8": residual.K8_SRC}
    paths = [write_variant(srcs[k], tag, edit)
             for k, tag, edit, _ in VARIANTS]
    built = cuda_build.build_all([srcs["K7"], srcs["K8"]] + paths)
    current = {"K7": built[0], "K8": built[1]}
    for k, (_, log) in current.items():
        print(f"  {k} as it is {label}: {ptxas(log)}")
    libs = {"K7": residual._k7, "K8": residual._k8}
    cases = {"K7": [c for c in chip_smoke.K7_CASES
                    if c[0] in ("16 lanes of 1080p", "the SVC base layer")],
             "K8": [c for c in chip_smoke.K8_CASES
                    if c[0] in ("16 lanes of 1080p", "1080p, a row QP plan")]}
    for (kernel, tag, _, n_kernels), (path, log) in zip(VARIANTS,
                                                         built[2:]):
        print(f"  {tag} {label}: {ptxas(log)}", flush=True)
        lib = libs[kernel]
        for what, *case in cases[kernel]:
            args = (chip_smoke.k7_case_args if kernel == "K7"
                    else chip_smoke.k8_case_args)(*case)
            packed = (mbscan.inter_residual_args if kernel == "K7"
                      else mbscan.select_parallel_args)(*args)
            wrapper = (residual.inter_tiles if kernel == "K7"
                       else residual.select_tiles)
            builds = {"as it is": current[kernel][0], "variant": path}
            lib.use(builds["as it is"])
            want = wrapper(*packed)
            ms = {t: [] for t in builds}
            for order in (("as it is", "variant"), ("variant", "as it is"),
                          ("as it is", "variant"), ("variant", "as it is")):
                for t in order:
                    lib.use(builds[t])
                    got = wrapper(*packed)
                    if not all(torch.equal(got[k], v)
                               for k, v in want.items()):
                        raise RuntimeError(f"{tag} differs on {what}")
                    ms[t].append(chip_smoke._cuda_ms(
                        lambda: wrapper(*packed), opts.reps))
            dev = {}
            for t in builds:
                lib.use(builds[t])
                dev[t] = chip_smoke.kernel_launches(
                    lambda: wrapper(*packed), traces=6,
                    want=n_kernels if t == "variant" else 1)[0]
            lib.use(builds["as it is"])
            print(f"    on {what} {tuple(args[0].shape[:2])} {label}: ms "
                  + "; ".join(f"{t} " + ", ".join(f"{x:.4f}" for x in v)
                              for t, v in ms.items())
                  + "; device us " + "; ".join(
                      f"{t} " + ", ".join(f"{n} {us:.1f}" for n, us in d)
                      for t, d in dev.items()), flush=True)
            del args, packed, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
