"""K7, the inter residual (`h264lab_tpu_torch/csrc/inter.cu`), and K8, the
parallel P select (`csrc/select.cu`), on the CUDA card: each wrapper's
time and host time, its kernels' device time, its bound, in turns
against an earlier build, and what the builds hold.

    python tools/torch_k78_bench.py [--baseline DIR] [--sass DIR]
                                    [--reps N] [--only WHAT] [--no-real]
                                    [--host-parts]

The inputs are the real ones of two encodes on the card, recorded at the
entries (`mbscan.inter_residual`, `mbscan.select_parallel`): the first P
step of 16 GOP lanes of 1920x1088 at QP 33, speed 2 (lane g on frames g,
g + 1, as `chip_smoke.py`'s main path), and the first P frame of one
lane of the same (one frame, where the wrappers' host time sets the
call); then `chip_smoke.py`'s seeded cases (`K7_CASES`, `K8_CASES`). For
each it prints the wrapper's ms (`residual.inter_tiles` or
`select_tiles` on the packed arguments, CUDA events over `--reps` calls
after a warm-up, as phase 20 takes it), its host us a call (the median
of 5 x `--reps` calls issued back to back, each on the host clock; the
host is shared, and a mean follows its stalls), the device us of each kernel of one call
(`chip_smoke.kernel_launches`, a trace of a second call), the byte bound
(`chip_smoke.k7_bytes`, `k8_bytes` at `chip_smoke.HBM_BYTES_PER_S`) and
the share of it reached.

`--baseline DIR` names an earlier tree of the repository (the parent
commit, unpacked into a gitignored directory with `git archive`). The
script loads its wrappers (`DIR/h264lab_tpu_torch/ops/residual.py`,
beside the current one) with its kernels (`DIR/h264lab_tpu_torch/csrc/
inter.cu` and `select.cu` with the headers beside them, built too),
checks on every input that its outputs equal the current ones, every
output, and times the two in turns: wrapper ms old, new, new, old, and
host us a call old, new, new, old twice (`TURNS`), the median of each
tree's four, all of them before the first profiler trace of the process
(a trace slows the host calls that follow it); and the K6 wrapper's host us on the recorded P step's
`symbolize` arguments in turns with the earlier tree's
(`DIR/h264lab_tpu_torch/ops/symbolize.py`), since K6 moved onto the
shared buffer code of `ops/cuda_build.py`.

`--sass DIR` disassembles each build (`cuobjdump -sass`) into DIR and
prints, per kernel, its SASS instruction count and the counts of the
opcodes that tell what holds it (`tools/torch_k6_bench.py`'s list and
the bulk copies' UBLKCP, SYNCS).

`--host-parts` also splits the current wrappers' host time a call on
the one-frame P step: the whole call, the call without its launch, the
input checks, the allocation, the output views and the device switch.

`--only WHAT` measures only the inputs whose name holds WHAT; `--no-real`
skips the two encodes.

Needs a CUDA device; every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import torch_k6_bench as k6b  # noqa: E402
from h264lab_tpu_torch.config import EncoderConfig, RunConfig  # noqa: E402
from h264lab_tpu_torch.models import mbscan  # noqa: E402
from h264lab_tpu_torch.ops import cuda_build, residual  # noqa: E402
from h264lab_tpu_torch.ops import symbolize as k6  # noqa: E402
from h264lab_tpu_torch.parallel.gop import GopBandEncoder  # noqa: E402
from h264lab_tpu_torch.utils.device import card_label  # noqa: E402
from h264lab_tpu_torch.utils.synthetic import chessboard_frame  # noqa: E402

KERNELS = {"K7": ("inter_residual_kernel",),
           "K8": ("select_parallel_kernel",)}
OPCODES = k6b.OPCODES + ("UBLKCP", "SYNCS", "VABSDIFF4", "IDP")
# the host-time turns of two trees, each median over its four
TURNS = ("old", "new", "new", "old", "old", "new", "new", "old")


def host_us(fn, reps):
    """The median host us of one call of `fn` over `reps` calls, each
    timed alone on the host clock and issued back to back after a
    warm-up call (the device works behind them; no synchronization
    inside)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def baseline_modules(tree):
    """An earlier tree's K7/K8 and K6 wrapper modules, loaded beside the
    current ones, with that tree's kernels built and loaded under them.
    Returns (residual module, symbolize module, {kernel: (library path,
    build log)})."""
    out = []
    for name in ("residual", "symbolize"):
        spec = importlib.util.spec_from_file_location(
            f"baseline_{name}", os.path.join(tree, "h264lab_tpu_torch",
                                             "ops", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out.append(mod)
    csrc = os.path.join(tree, "h264lab_tpu_torch", "csrc")
    built = cuda_build.build_all([os.path.join(csrc, f) for f in (
        "inter.cu", "select.cu", "symbolize.cu")])
    out[0]._k7.use(built[0][0])
    out[0]._k8.use(built[1][0])
    out[1]._lib.use(built[2][0])
    return out[0], out[1], {"K7": built[0], "K8": built[1]}


def record_real():
    """The `inter_residual`, `select_parallel` and `symbolize` arguments of
    the first P step of 16 lanes and of one lane of 1920x1088 at QP 33,
    speed 2, on the card: {what: {entry: args}}."""
    w, h = chip_smoke.WIDTH, chip_smoke.HEIGHT
    lanes = chip_smoke.LANES
    frames = [chessboard_frame(w, h, t) for t in range(lanes + 1)]
    gray = np.full((h // 2, w // 2), 128, np.uint8)
    run = RunConfig(qp_min=chip_smoke.QP, qp_max=chip_smoke.QP,
                    encode_speed=2)
    out = {}
    for what, n in ((f"{lanes}-lane P step", lanes), ("one-frame P step",
                                                       1)):
        calls = {}
        wrapped = {}
        for name in ("inter_residual", "select_parallel", "symbolize"):
            fn = getattr(mbscan, name)
            wrapped[name] = fn

            def rec(*a, _name=name, _fn=fn, **kw):
                calls[_name] = a
                return _fn(*a, **kw)
            setattr(mbscan, name, rec)
        try:
            enc = GopBandEncoder(EncoderConfig(
                width=w, height=h, gop=chip_smoke.GOP, qp=chip_smoke.QP),
                n_gop=n)
            for t in range(2):
                calls.clear()
                enc.encode_step([(frames[g + t], gray, gray)
                                 for g in range(n)], run)
        finally:
            for name, fn in wrapped.items():
                setattr(mbscan, name, fn)
        torch.cuda.synchronize()
        out[what] = {k: chip_smoke.to_device(v, "cpu") for k, v in
                     calls.items()}
        del enc
        torch.cuda.empty_cache()
    return out


def host_turns(kernel, mods, packed, reps):
    """The wrapper's host us a call (`host_us`, 5 x `reps` calls) on one
    input; with an "old" module in turns (`TURNS`), the median of each
    tree's four. Taken
    before any profiler trace in the process, which slows the host calls
    that follow it."""
    name = "inter_tiles" if kernel == "K7" else "select_tiles"
    fns = {tag: (lambda f=getattr(mod, name): f(*packed))
           for tag, mod in mods.items()}
    if "old" not in fns:
        return dict(host_us=host_us(fns["new"], 5 * reps))
    hosts = [(tag, host_us(fns[tag], 5 * reps)) for tag in TURNS]
    return dict(host_turns=hosts,
                host_us=statistics.median([h for t, h in hosts if t == "new"]),
                old_host_us=statistics.median([h for t, h in hosts
                                               if t == "old"]))


def measure(kernel, mods, args, packed, reps):
    """One kernel on one input: its bound, ms and each kernel's device
    us; with an "old" module, the old wrapper's outputs against the new
    ones and the two timed in turns (old, new, new, old)."""
    name = "inter_tiles" if kernel == "K7" else "select_tiles"
    fns = {tag: (lambda f=getattr(mod, name): f(*packed))
           for tag, mod in mods.items()}
    got = fns["new"]()
    want = dict(got)
    if kernel == "K8":
        want["lev_inter"] = args[7]["lev_inter"]
    moved = (chip_smoke.k7_bytes if kernel == "K7" else chip_smoke.k8_bytes)(
        args, want)
    row = dict(bound_ms=moved / chip_smoke.HBM_BYTES_PER_S * 1e3)
    n_kernels = len(KERNELS[kernel])

    def device_us(fn):
        return dict(chip_smoke.kernel_launches(fn, traces=6,
                                               want=n_kernels)[0])
    if "old" in fns:
        old = fns["old"]()
        row["baseline_equal"] = list(old) == list(got) and all(
            torch.equal(old[k], v) for k, v in got.items())
        del old
        turns = [(tag, chip_smoke._cuda_ms(fns[tag], reps))
                 for tag in ("old", "new", "new", "old")]
        row["kernels"], row["old_kernels"] = (device_us(fns["new"]),
                                              device_us(fns["old"]))
        row["turns"] = turns
        row["ms"] = (turns[1][1] + turns[2][1]) / 2
        row["old_ms"] = (turns[0][1] + turns[3][1]) / 2
    else:
        row["ms"] = chip_smoke._cuda_ms(fns["new"], reps)
        row["kernels"] = device_us(fns["new"])
    del got
    return row


def _kernels(k, n):
    return ", ".join(f"{name} {us:.1f}" for name, us in k.items()) + (
        f" (sum {sum(k.values()):.1f})" if len(k) == n else
        " (a trace lost a kernel)")


def report(kernel, what, row, label):
    n = len(KERNELS[kernel])
    line = (f"  {kernel} on {what} {tuple(row['shape'])} {label}: "
            f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({100 * row['bound_ms'] / row['ms']:.1f}%); device us "
            f"{_kernels(row['kernels'], n)}; {row['host_us']:.1f} us of "
            "host time a call")
    if "turns" in row:
        line += (f"; in turns old, new, new, old: " + ", ".join(
            f"{ms:.4f}" for _, ms in row["turns"])
            + f" ms; old {row['old_ms']:.4f} ms "
            f"({100 * row['bound_ms'] / row['old_ms']:.1f}%), new / old "
            f"{row['ms'] / row['old_ms']:.3f}; old device us "
            f"{_kernels(row['old_kernels'], len(row['old_kernels']))}; "
            "host us a call in turns: "
            + ", ".join(f"{t} {us:.1f}" for t, us in row["host_turns"])
            + f" (medians new / old {row['host_us'] / row['old_host_us']:.3f}"
            f"); outputs equal: {row['baseline_equal']}")
    print(line, flush=True)


def host_parts(kernel, packed, reps):
    """Where the current wrapper's host time a call goes (median us over
    5 x `reps` calls each): the whole call, the call without its launch
    (`cuda_build.call` stubbed), the input checks (`cuda_build.pointers`),
    the allocation, the output views and the device switch."""
    k7 = kernel == "K7"
    wrapper = residual.inter_tiles if k7 else residual.select_tiles
    n, nmb = packed[0].shape[:2]
    if k7:
        plan = residual._k7_plan(n, nmb, packed[17], packed[7].ndim == 2,
                                 packed[15] is not None,
                                 tuple(packed[3].shape))
        tensors = tuple(packed[:15]) + tuple(packed[15] or ())
    else:
        plan = residual._k8_plan(n, nmb, nmb // packed[17],
                                 packed[3].ndim == 2)
        tensors = tuple(packed[:17])
    checks, nbytes, views, _ = plan
    index, dev = packed[0].get_device(), packed[0].device
    reps *= 5
    out = dict(call=host_us(lambda: wrapper(*packed), reps))
    launch = cuda_build.call
    cuda_build.call = lambda fn, words, what, index: None
    try:
        out["without the launch"] = host_us(lambda: wrapper(*packed), reps)
    finally:
        cuda_build.call = launch
    out["input checks"] = host_us(
        lambda: cuda_build.pointers("x", tensors, checks, index), reps)
    out["allocation"] = host_us(
        lambda: torch.empty(nbytes, dtype=torch.uint8, device=dev), reps)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out[f"{len(views)} output views"] = host_us(
        lambda: cuda_build.buffer_views(buf, views), reps)

    def switch():
        with torch.cuda.device(index):
            pass
    out["device switch"] = host_us(switch, reps)
    return out


def k6_host_turns(mods, args, reps, label):
    """K6's wrapper host us a call on `args` in turns with the earlier
    tree's (`TURNS`), the median of each tree's four; its outputs
    equal."""
    fns = {tag: k6b.wrapper_call(mod, args) for tag, mod in mods.items()}
    a, b = fns["old"](), fns["new"]()
    equal = set(a) == set(b) and all(torch.equal(a[k], v)
                                     for k, v in b.items())
    hosts = [(tag, host_us(fns[tag], 5 * reps)) for tag in TURNS]
    new = statistics.median([h for t, h in hosts if t == "new"])
    old = statistics.median([h for t, h in hosts if t == "old"])
    print(f"  K6 wrapper host us a call {label} in turns "
          + ", ".join(f"{t} {us:.1f}" for t, us in hosts)
          + f" (medians new / old {new / old:.3f}); outputs equal: {equal}",
          flush=True)
    return dict(host_turns=hosts, host_us=new, old_host_us=old,
                baseline_equal=equal)


def n_of(what):
    """The lanes of a recorded input, from its name."""
    return 1 if what.startswith("one-frame") else chip_smoke.LANES


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR")
    ap.add_argument("--sass", metavar="DIR")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", metavar="WHAT")
    ap.add_argument("--no-real", action="store_true")
    ap.add_argument("--host-parts", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k78_bench: no CUDA device", file=sys.stderr)
        return 2
    label = f"[{card_label()}]"
    print(label)
    built = cuda_build.build_all([residual.K7_SRC, residual.K8_SRC])
    mods = {"K7": {"new": residual}, "K8": {"new": residual}}
    paths = {"new": dict(zip(("K7", "K8"), (p for p, _ in built)))}
    result = dict(card=label, ptxas={"new": {k: k6b.ptxas(log) for k, (_, log)
                                              in zip(("K7", "K8"), built)}},
                  inputs={})
    k6_mods = None
    if opts.baseline:
        old, old_k6, old_built = baseline_modules(opts.baseline)
        for k in ("K7", "K8"):
            mods[k]["old"] = old
        k6_mods = {"new": k6, "old": old_k6}
        paths["old"] = {k: v[0] for k, v in old_built.items()}
        result["ptxas"]["old"] = {k: k6b.ptxas(v[1])
                                  for k, v in old_built.items()}
    for tag, per in result["ptxas"].items():
        for k, lines in per.items():
            for line in lines:
                print(f"  {tag} {k} ptxas: {line}")
    if opts.sass:
        k6b.OPCODES = OPCODES
        result["sass"] = {}
        for tag, per in paths.items():
            for k, path in per.items():
                k6b.KERNELS = KERNELS[k]
                result["sass"][f"{tag} {k}"] = k6b.sass_counts(
                    path, opts.sass, f"{tag}_{k}")
                for fn, c in result["sass"][f"{tag} {k}"].items():
                    print(f"  {tag} SASS {fn}: {c}")
    cases = []
    if not opts.no_real:
        for what, calls in record_real().items():
            cases.append(("K7", what, calls["inter_residual"]))
            cases.append(("K8", what, calls["select_parallel"]))
            if opts.host_parts and n_of(what) == 1:
                for kernel, entry in (("K7", "inter_residual"),
                                      ("K8", "select_parallel")):
                    args = chip_smoke.to_device(calls[entry], "cuda")
                    packed = (mbscan.inter_residual_args if kernel == "K7"
                              else mbscan.select_parallel_args)(*args)
                    parts = host_parts(kernel, packed, opts.reps)
                    result["inputs"][f"{kernel} {what} host parts"] = parts
                    print(f"  {kernel} wrapper host us a call on the {what} "
                          f"{label}, medians: " + ", ".join(
                              f"{k} {v:.1f}" for k, v in parts.items()),
                          flush=True)
            if k6_mods is not None and (not opts.only or opts.only in what):
                args = mbscan.symbolize_args(*chip_smoke.to_device(
                    calls["symbolize"], "cuda"))
                result["inputs"][f"K6 {what}"] = k6_host_turns(
                    k6_mods, args, opts.reps, f"on the {what}")
    for what, *case in chip_smoke.K7_CASES:
        cases.append(("K7", f"seeded {what}", chip_smoke.k7_case_args(*case)))
    for what, *case in chip_smoke.K8_CASES:
        cases.append(("K8", f"seeded {what}", chip_smoke.k8_case_args(*case)))
    prepared = []
    for kernel, what, call in cases:
        if opts.only and opts.only not in what:
            continue
        args = chip_smoke.to_device(call, "cuda")
        packed = (mbscan.inter_residual_args if kernel == "K7"
                  else mbscan.select_parallel_args)(*args)
        prepared.append((kernel, what, args, packed))
    # every host time before the first trace
    hosts = [host_turns(kernel, mods[kernel], packed, opts.reps)
             for kernel, _, _, packed in prepared]
    for (kernel, what, args, packed), host in zip(prepared, hosts):
        row = measure(kernel, mods[kernel], args, packed, opts.reps)
        row.update(host)
        row["shape"] = list(args[0].shape[:2])
        result["inputs"][f"{kernel} {what}"] = row
        report(kernel, what, row, label)
    del prepared
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
