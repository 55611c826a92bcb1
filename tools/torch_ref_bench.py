"""K11, the reference planes (`h264lab_tpu_torch/csrc/refplanes.cu`), and
K9, the SVC 2x downsampling (`csrc/resample.cu` `downsample_kernel`), on
the CUDA card: each wrapper's time and host time, its kernel's device
time, its byte bound and its share, in turns against an earlier build,
beside the card's achievable byte rate.

    python tools/torch_ref_bench.py [--baseline DIR] [--reps N]
                                    [--host-parts] [--variants]

The inputs are the real ones of encodes on the card, recorded at the
stage entries: K11's (`refstate.prepare_reference`) of the first P step
of 16 GOP lanes of 1920x1088 at QP 33, speed 2 (lane g on frames g, g +
1, as `chip_smoke.py`'s main path) and of one lane of the same (one
frame, where the wrapper's host time sets the call); K9's
(`resample.downsample_planes`) of a two-layer SVC frame at 1920x1088
over 960x544 with inter-layer prediction (the three 1080p planes). For
each it prints the wrapper's ms (`refplanes.planes_k11`,
`resample.downsample_k9`; CUDA events over `--reps` calls after a
warm-up), its host us a call (`torch_k78_bench.host_us`: the median of 5
x `--reps` calls issued back to back), its kernel's device us (a trace of
a second call, `chip_smoke.kernel_launches`), the byte bound
(`chip_smoke.stage_bytes` at `chip_smoke.HBM_BYTES_PER_S`) and the share
of it reached, and checks the outputs against the plain version
(`refstate.prepare_reference_plain`, `resample.downsample2x`). As a
yardstick, a device-to-device `copy_` of a buffer half the bound's bytes
(it reads and writes them: the same bytes moved) is timed on each input
in the same call: the byte rate this card reaches there.

`--baseline DIR` names an earlier tree of the repository (the parent
commit, unpacked into a gitignored directory with `git archive`). The
script loads its wrappers (`DIR/h264lab_tpu_torch/ops/refplanes.py` and
`resample.py`, beside the current ones) with its kernels
(`DIR/h264lab_tpu_torch/csrc/refplanes.cu` and `resample.cu`, built
too), checks on every input that its outputs equal the current ones, and
times the two in turns: wrapper ms old, new, new, old, and host us a call
old, new, new, old twice (`torch_k78_bench.TURNS`), the medians of each
tree's four, all of them before the first profiler trace of the process
(a trace slows the host calls that follow it).

`--host-parts` splits the current wrappers' host time a call on the
one-frame step (K11) and the SVC frame (K9): the whole call, the call
without its launch (`cuda_build.call` stubbed), the input checks
(`cuda_build.pointers`), the allocation, the output views
(`cuda_build.buffer_views`) beside the same views cut by one
`split_with_sizes` and a `view` each and by one
`unflatten_dense_tensors`, the device's stream lookup, the
launch alone (`cuda_build.call` on the call's words) and the bare ctypes
call of the entry point on a prepared word array.

`--variants` times K11's design variants (`VARIANTS`: a ring of two
stages, a persistent grid whose blocks keep the next chunk's bulk copies
in flight while they write the current one; other chunk and block sizes,
the source's `kChunk` and `kThreads` replaced;
each written from the current source into the gitignored
`h264lab_tpu_torch/_build/variants/` with the headers beside it) in
turns with the source's build on both K11 inputs (current, variant,
variant, current), outputs equal, with each build's ptxas line.

Every build's ptxas registers, shared memory, stack and spills are
printed. Needs a CUDA device; every line names the card and its power
limit. It imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from torch_k78_bench import TURNS, host_us  # noqa: E402
from h264lab_tpu_torch.config import EncoderConfig, RunConfig  # noqa: E402
from h264lab_tpu_torch.models import refstate  # noqa: E402
from h264lab_tpu_torch.models.svc import SvcEncoder  # noqa: E402
from h264lab_tpu_torch.ops import cuda_build, refplanes, resample  # noqa: E402
from h264lab_tpu_torch.parallel.gop import GopBandEncoder  # noqa: E402
from h264lab_tpu_torch.utils.device import card_label  # noqa: E402
from h264lab_tpu_torch.utils.synthetic import chessboard_sequence  # noqa: E402

VARIANTS_DIR = cuda_build.BUILD_DIR / "variants"
SIZES = ("constexpr int kThreads = 256;\n"
         "constexpr int kChunk = 16;      // MBs a block: a power of 2, at "
         "least 4\n")
KERNEL = ("// grid (chunks of a row, L, mbh): blockIdx.z 0 the first MB row, "
          "1 the\n")
KERNEL_END = "// The widest store, 16, 8 or 4 bytes, that divides a row pitch."
LAUNCH = ("  const dim3 grid((a.mbw + kChunk - 1) / kChunk, (unsigned)n, "
          "a.mbh);\n  reference_planes_kernel<<<grid, kThreads, 0, "
          "(cudaStream_t)w[11]>>>(a);\n")
# the ring of two stages: a persistent grid (as many blocks as fit on the
# card, at least 6 an SM), each block walking the chunks in the kernel's
# order with the next chunk's bulk copies in flight in a second shared
# copy while it writes the current one
TWO_STAGES = r"""// Wait until the mbarrier's phase of `parity` has completed.
__device__ __forceinline__ void wait_parity(unsigned long long* bar,
                                            unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(tq_smem(bar)), "r"(parity) : "memory");
  } while (!done);
}

// chunk w in the one-stage grid's order
__device__ __forceinline__ Chunk work_of(const Args& a, int w, int pics) {
  const int chunks = (a.mbw + kChunk - 1) / kChunk;
  const int z = w / (chunks * pics), rem = w - z * chunks * pics;
  const int pic = rem / chunks;
  return chunk_of(a, rem - pic * chunks, pic,
                  z == 0 ? 0 : z == 1 ? a.mbh - 1 : z - 1);
}

__global__ void __launch_bounds__(kThreads, 6)
reference_planes_kernel(const Args a, int pics, int works) {
  __shared__ Smem s[2];
  if (threadIdx.x == 0) {
    for (int st = 0; st < 2; ++st) {
      tq_mbar_init(&s[st].bar);
      const int w = blockIdx.x + st * gridDim.x;
      if (w < works) load_chunk(a, s[st], work_of(a, w, pics));
    }
  }
  __syncthreads();
  int i = 0;
  for (int w = blockIdx.x; w < works; w += gridDim.x, ++i) {
    const int st = i & 1;
    wait_parity(&s[st].bar, (i >> 1) & 1);
    write_chunk(a, s[st], work_of(a, w, pics));
    __syncthreads();                // stage st read by every thread
    const int next = w + 2 * gridDim.x;
    if (threadIdx.x == 0 && next < works)
      load_chunk(a, s[st], work_of(a, next, pics));
  }
}

"""
TWO_STAGES_LAUNCH = r"""  const long long works =
      (long long)((a.mbw + kChunk - 1) / kChunk) * n * a.mbh;
  static int cap = 0;
  if (cap == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, reference_planes_kernel, kThreads, 0);
    cap = sms * per;
  }
  const int blocks = works < cap ? (int)works : cap;
  reference_planes_kernel<<<blocks, kThreads, 0, (cudaStream_t)w[11]>>>(
      a, (int)n, (int)works);
"""


def _sub(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"variant anchor not found once: {old[:60]!r}")
    return text.replace(old, new)


def sizes(chunk, threads):
    """K11 with `chunk` MBs and `threads` threads a block."""
    return lambda src: _sub(src, SIZES, (
        f"constexpr int kThreads = {threads};\n"
        f"constexpr int kChunk = {chunk};\n"))


def two_stages(src):
    """K11 with a ring of two stages (`TWO_STAGES`)."""
    a, b = src.index(KERNEL), src.index(KERNEL_END)
    return _sub(src[:a] + TWO_STAGES + src[b:], LAUNCH, TWO_STAGES_LAUNCH)


# K11 variants: (name, the source's transform)
VARIANTS = (("two stages, persistent", two_stages),
            ("chunk 32, 256 threads", sizes(32, 256)),
            ("chunk 8, 128 threads", sizes(8, 128)))


def record_real():
    """The stage entries' arguments of the real inputs, on the host:
    {what: (kernel, args)}."""
    w, h = chip_smoke.WIDTH, chip_smoke.HEIGHT
    lanes = chip_smoke.LANES
    frames = list(chessboard_sequence(w, h, lanes + 1))
    run = RunConfig(qp_min=chip_smoke.QP, qp_max=chip_smoke.QP,
                    encode_speed=2)
    cfg = EncoderConfig(width=w, height=h, gop=chip_smoke.GOP,
                        qp=chip_smoke.QP)
    out = {}
    for what, n in ((f"{lanes}-lane P step", lanes),
                    ("one-frame P step", 1)):
        enc = GopBandEncoder(cfg, n_gop=n)
        enc.encode_step(frames[:n], run)
        refs = []
        with chip_smoke.recorded_calls("prepare_reference", refs,
                                       "models.refstate"):
            enc.encode_step(frames[1:n + 1], run)
        torch.cuda.synchronize()
        out[what] = ("K11", chip_smoke.to_device(refs[0], "cpu"))
        del enc, refs
        torch.cuda.empty_cache()
    svc = SvcEncoder(EncoderConfig(width=w, height=h, gop=chip_smoke.GOP,
                                   qp=chip_smoke.QP, num_layers=2,
                                   inter_layer_pred_flag=True))
    down = []
    with chip_smoke.recorded_calls("downsample_planes", down,
                                   "ops.resample"):
        svc.encode(*frames[0], run)
    torch.cuda.synchronize()
    out[f"{w}x{h} SVC frame"] = ("K9", chip_smoke.to_device(down[0], "cpu"))
    del svc, down
    torch.cuda.empty_cache()
    return out


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def baseline_modules(tree):
    """An earlier tree's K11 and K9 wrapper modules, loaded beside the
    current ones, with that tree's kernels built and loaded under them.
    Returns ({kernel: module}, {kernel: (library path, build log)})."""
    ops = os.path.join(tree, "h264lab_tpu_torch", "ops")
    csrc = os.path.join(tree, "h264lab_tpu_torch", "csrc")
    mods = {"K11": load_module(os.path.join(ops, "refplanes.py"),
                               "baseline_refplanes"),
            "K9": load_module(os.path.join(ops, "resample.py"),
                              "baseline_resample")}
    built = cuda_build.build_all([os.path.join(csrc, "refplanes.cu"),
                                  os.path.join(csrc, "resample.cu")])
    mods["K11"]._lib.use(built[0][0])
    mods["K9"]._lib.use(built[1][0])
    return mods, {"K11": built[0], "K9": built[1]}


def wrapper_of(kernel, mod, args):
    if kernel == "K11":
        return lambda: mod.planes_k11(*args)
    return lambda: mod.downsample_k9(*args)


def plain_of(kernel, args):
    if kernel == "K11":
        return refstate.prepare_reference_plain(*args)
    return tuple(resample.downsample2x(p) for p in args)


def items(x):
    return list(x.items()) if isinstance(x, dict) else list(enumerate(x))


def equal(a, b):
    a, b = items(a), items(b)
    return [k for k, _ in a] == [k for k, _ in b] and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for (_, x), (_, y) in zip(a, b))


def ptxas_report(tag, kernel, log, label):
    lines = chip_smoke.ptxas_lines(log)
    numbers = chip_smoke.ptxas_numbers(lines)
    for name, v in numbers.items():
        print(f"  {tag} {kernel} {name} {label}: {v['registers']} "
              f"registers, {v['smem']} bytes of shared memory, {v['stack']} "
              f"bytes of stack, spills {v['spill_stores']} B stored and "
              f"{v['spill_loads']} B loaded", flush=True)
    return numbers


def copy_yardstick(nbytes, reps):
    """ms of a device-to-device `copy_` that moves `nbytes` (reads and
    writes nbytes / 2), and its byte rate in TB/s."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = chip_smoke._cuda_ms(lambda: dst.copy_(src), reps)
    del src, dst
    return ms, 2 * (nbytes // 2) / ms / 1e9


def host_parts(kernel, args, reps):
    """Where the current wrapper's host time a call goes (median us over
    5 x `reps` calls each)."""
    if kernel == "K11":
        y, u, v, mbw, mbh = args
        specs, nbytes, views, _, _ = refplanes._plan(u.shape[0], mbw, mbh,
                                                     True)
        tensors = (y, u, v)
    else:
        tensors = tuple(args)
        specs, nbytes, views, _, _ = resample._down_plan(
            tuple(p.shape for p in args))
    wrapper = wrapper_of(kernel, refplanes if kernel == "K11" else resample,
                         args)
    index, dev = tensors[0].get_device(), tensors[0].device
    reps *= 5
    out = dict(call=host_us(wrapper, reps))
    launch = cuda_build.call
    cuda_build.call = lambda fn, words, what, index: None
    try:
        out["without the launch"] = host_us(wrapper, reps)
    finally:
        cuda_build.call = launch
    out["input checks"] = host_us(
        lambda: cuda_build.pointers("x", tensors, specs, index), reps)
    out["allocation"] = host_us(
        lambda: torch.empty(nbytes, dtype=torch.uint8, device=dev), reps)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out[f"{len(views)} output views"] = host_us(
        lambda: cuda_build.buffer_views(buf, views), reps)
    sizes = [int(torch.Size(v[2]).numel()) for v in views]
    sizes.append(nbytes - sum(sizes))
    shapes = [v[2] for v in views]

    def split():
        parts = buf.split_with_sizes(sizes)
        return [t.view(shape) for t, shape in zip(parts, shapes)]
    if all(v[4] == sum(sizes[:k]) for k, v in enumerate(views)):
        out["the views by split_with_sizes"] = host_us(split, reps)
        meta = [torch.empty(shape, dtype=torch.uint8, device="meta")
                for shape in shapes]
        unflatten = torch._C._nn.unflatten_dense_tensors
        flat = buf[:sum(sizes[:-1])]
        out["the views by unflatten_dense_tensors"] = host_us(
            lambda: unflatten(flat, meta), reps)
    out["stream lookup"] = host_us(lambda: cuda_build.stream_of(index), reps)
    words = []
    cuda_build.call, launch = (lambda fn, w, what, index: words.append(
        (fn, list(w))), cuda_build.call)
    try:
        kept = wrapper()            # the planes the launches below write
    finally:
        cuda_build.call = launch
    fn, w = words[0]
    out["launch (cuda_build.call)"] = host_us(
        lambda: cuda_build.call(fn, w, "x", index), reps)
    import array
    arr = array.array("q", w)
    ptr = arr.buffer_info()[0]
    out["bare ctypes call"] = host_us(lambda: fn(ptr), reps)
    torch.cuda.synchronize()
    del kept
    return out


def variant_builds(label):
    """K11 built with each of `VARIANTS`: {name: library path}."""
    src = refplanes.SRC.read_text()
    VARIANTS_DIR.mkdir(parents=True, exist_ok=True)
    for header in refplanes.SRC.parent.glob("*.h"):
        shutil.copy(header, VARIANTS_DIR / header.name)
    paths = []
    for k, (name, transform) in enumerate(VARIANTS):
        path = VARIANTS_DIR / f"refplanes_variant{k}.cu"
        path.write_text(transform(src))
        paths.append(path)
    built = cuda_build.build_all(paths)
    out = {}
    for (name, _), (path, log) in zip(VARIANTS, built):
        ptxas_report("variant", f"K11 ({name})", log, label)
        out[name] = path
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--host-parts", action="store_true")
    ap.add_argument("--variants", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ref_bench: no CUDA device", file=sys.stderr)
        return 2
    label = f"[{card_label()}]"
    print(label, flush=True)
    t_start = time.perf_counter()
    built = cuda_build.build_all([refplanes.SRC, resample.SRC])
    result = dict(card=label, ptxas={"new": {}}, inputs={})
    mods = {"K11": {"new": refplanes}, "K9": {"new": resample}}
    for kernel, (_, log) in zip(("K11", "K9"), built):
        result["ptxas"]["new"][kernel] = ptxas_report("new", kernel, log,
                                                      label)
    if opts.baseline:
        old, old_built = baseline_modules(opts.baseline)
        result["ptxas"]["old"] = {}
        for kernel, (_, log) in old_built.items():
            mods[kernel]["old"] = old[kernel]
            result["ptxas"]["old"][kernel] = ptxas_report("old", kernel, log,
                                                          label)
    variants = variant_builds(label) if opts.variants else {}
    real = record_real()
    prepared = []
    for what, (kernel, args) in real.items():
        args = chip_smoke.to_device(args, "cuda")
        want = plain_of(kernel, args)
        fns = {tag: wrapper_of(kernel, mod, args)
               for tag, mod in mods[kernel].items()}
        row = dict(kernel=kernel, plain_equal={
            tag: equal(fn(), want) for tag, fn in fns.items()})
        moved = chip_smoke.stage_bytes(kernel, args, [w for _, w in
                                                      items(want)])
        row["bytes"] = moved
        row["bound_ms"] = moved / chip_smoke.HBM_BYTES_PER_S * 1e3
        del want
        prepared.append((what, kernel, args, fns, row))
        torch.cuda.synchronize()
    # every host time before the first trace
    for what, kernel, args, fns, row in prepared:
        if "old" in fns:
            hosts = [(tag, host_us(fns[tag], 5 * opts.reps))
                     for tag in TURNS]
            row["host_turns"] = hosts
            row["host_us"] = statistics.median(
                [us for t, us in hosts if t == "new"])
            row["old_host_us"] = statistics.median(
                [us for t, us in hosts if t == "old"])
        else:
            row["host_us"] = host_us(fns["new"], 5 * opts.reps)
        if opts.host_parts and (kernel == "K9" or what.startswith("one")):
            row["host_parts"] = host_parts(kernel, args, opts.reps)
            print(f"  {kernel} wrapper host us a call on the {what} {label}, "
                  "medians: " + ", ".join(
                      f"{k} {v:.1f}" for k, v in row["host_parts"].items()),
                  flush=True)
    for what, kernel, args, fns, row in prepared:
        if "old" in fns:
            row["old_equal"] = equal(fns["old"](), fns["new"]())
            turns = [(tag, chip_smoke._cuda_ms(fns[tag], opts.reps))
                     for tag in ("old", "new", "new", "old")]
            row["turns"] = turns
            row["ms"] = (turns[1][1] + turns[2][1]) / 2
            row["old_ms"] = (turns[0][1] + turns[3][1]) / 2
        else:
            row["ms"] = chip_smoke._cuda_ms(fns["new"], opts.reps)
        row["copy_ms"], row["copy_tb_s"] = copy_yardstick(row["bytes"],
                                                          opts.reps)
        for tag, fn in fns.items():
            k, _ = chip_smoke.kernel_launches(fn, traces=6)
            row[f"{tag}_device"] = k
        result["inputs"][what] = row
        dev = {tag: sum(us for _, us in row[f"{tag}_device"])
               for tag in fns}
        line = (f"  {kernel} on the {what} {label}: {row['ms']:.4f} ms, "
                f"host {row['host_us']:.1f} us a call, device "
                + ", ".join(f"{n} {us:.1f} us" for n, us in
                            row["new_device"])
                + f"; bound {row['bound_ms'] * 1e3:.2f} us for "
                f"{row['bytes'] / 1e6:.2f} MB ({100 * row['bound_ms'] / row['ms']:.1f}%"
                " of the wrapper's time"
                + (f", {100e3 * row['bound_ms'] / dev['new']:.1f}% of the "
                   "device time" if dev["new"] else "")
                + f"); copy_ of the same bytes {row['copy_ms'] * 1e3:.2f} us"
                f" ({row['copy_tb_s']:.2f} TB/s"
                + (f", the kernel at {100 * row['copy_ms'] * 1e3 / dev['new']:.1f}%"
                   " of its rate" if dev["new"] else "")
                + f"); equal to the plain version: {row['plain_equal']}")
        if "old" in fns:
            line += (f"; in turns old, new, new, old: " + ", ".join(
                f"{ms:.4f}" for _, ms in row["turns"])
                + f" ms, new / old {row['ms'] / row['old_ms']:.3f}; old "
                "device " + ", ".join(f"{n} {us:.1f} us" for n, us in
                                      row["old_device"])
                + (f" (new / old {dev['new'] / dev['old']:.3f})"
                   if dev["new"] and dev["old"] else "")
                + "; host us a call in turns: " + ", ".join(
                    f"{t} {us:.1f}" for t, us in row["host_turns"])
                + f" (medians new / old "
                f"{row['host_us'] / row['old_host_us']:.3f}); outputs equal "
                f"to the old build's: {row['old_equal']}")
        print(line, flush=True)
    for name, path in variants.items():
        mod = load_module(refplanes.__file__, "variant_refplanes")
        mod._lib.use(path)
        for what, kernel, args, fns, row in prepared:
            if kernel != "K11":
                continue
            var = wrapper_of("K11", mod, args)
            same = equal(var(), fns["new"]())
            turns = [(tag, chip_smoke._cuda_ms(
                fns["new"] if tag == "current" else var, opts.reps))
                for tag in ("current", "variant", "variant", "current")]
            k, _ = chip_smoke.kernel_launches(var, traces=6)
            result["inputs"][f"{what}, {name}"] = dict(
                turns=turns, device=k, equal=same)
            print(f"  K11 {name} on the {what} {label}: in turns current, "
                  "variant, variant, current: " + ", ".join(
                      f"{ms:.4f}" for _, ms in turns) + " ms; device "
                  + ", ".join(f"{n} {us:.1f} us" for n, us in k)
                  + f"; outputs equal: {same}", flush=True)
    print(f"torch_ref_bench {time.perf_counter() - t_start:.1f} s {label}")
    print(json.dumps(result, default=str))
    ok = all(all(r["plain_equal"].values()) and r.get("old_equal", True)
             for r in result["inputs"].values() if "plain_equal" in r)
    ok = ok and all(r["equal"] for r in result["inputs"].values()
                    if "equal" in r)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
