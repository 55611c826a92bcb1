"""K4, the dense 16x16 motion search, and K5, the partition search
(`h264lab_tpu_torch/csrc/me.cu`), on the CUDA card: their wrappers' time
at the shapes the encode paths give them, in turns against an earlier
build, and what the build holds.

    python tools/torch_k4_bench.py [--baseline DIR] [--sass DIR]
                                   [--phases SRC] [--reps N]

The inputs are `chip_smoke.py`'s seeded K4 inputs (`K4_CASES`,
`utils.synthetic.me_inputs`): 16 frames of 1080p over 16 lanes (the GOP
lanes' P step), one 1080p frame with and without the sub-pel stage (the
sequential speed-0 P frame; speeds 9 and 10), the SVC base layer (1, 60 x
34 MBs), a mesh band at a row offset (1, 120 x 34 MBs) and the small and
tile-edge cases. For each it prints K4's wrapper ms
(`me.motion_search_tiles`, CUDA events over `--reps` calls after a
warm-up, as `chip_smoke.py`'s phase 18 takes it), the wrapper's host us
a call (the host clock over `--reps` calls issued back to back, before
the synchronization), its bound (`chip_smoke.search_bound`) and the
share of it reached, and from a `torch.profiler` trace of one call the
launches of K4's kernels and their device us, beside the build's ptxas
registers, shared memory and spills. K5 is measured the same way on K4's
planes of each sub-pel input (`chip_smoke.k5_args`: one K4 call), its
bound from the operations the function needs
(`chip_smoke.K5_OPS_NEEDED_PER_MB`), and beside it the share of the
bound on the older count (`chip_smoke.K5_OPS_PER_MB`).

`--baseline DIR` names an earlier tree of the repository (for example
the parent commit, unpacked into a gitignored directory with `git
archive`). The script loads its K4 and K5 wrappers (`DIR/h264lab_tpu_torch/
ops/me.py`, beside the current one) with their kernels (`DIR/
h264lab_tpu_torch/csrc/me.cu`, built too), checks on every input that
their outputs equal the current K4's and K5's, and times each pair of
wrappers in turns (old, new, new, old).

`--sass DIR` disassembles each build (`cuobjdump -sass`) into DIR and
prints, per kernel of K4 and K5, its SASS instruction count and the
counts of the opcodes the sweeps use (the packed byte SAD and average, funnel
shifts, byte permutes, shuffles, shared loads).

`--phases SRC` names a copy of `csrc/me.cu` with clock64() stamps (not
kept in the repository) whose warps sum the cycles of each phase into
the slots of `PHASES`, then the count of MBs, of warps and the warps'
whole cycles, and which exports `int h264lab_me_phases(unsigned long
long* out)` to copy the 16 sums out and zero them. Its entry point and
buffers are the current K4's. After a warm-up, one launch per input
gives the mean cycles of each phase: per warp for the block's phases
(the strip's copies issued and the coarse grid's inputs staged, the
coarse search, the barrier and the wait for the strip), per MB for the
MB's (the predictor and the centres, the full-pel SADs, the full-pel
reduce-scatter and key, the planes, the quarter-pel SADs, the
quarter-pel reduce-scatter and key, the prediction and outputs), and a
warp's whole life.

Needs a CUDA device; every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from h264lab_tpu_torch.ops import cuda_build, me  # noqa: E402
from h264lab_tpu_torch.utils.device import card_label  # noqa: E402

# the opcodes counted in each K4 kernel's SASS
OPCODES = ("VABSDIFF4", "VIMNMX", "IDP", "PRMT", "SHF", "LOP3", "IADD3",
           "IMAD", "SHFL", "REDUX", "LDS", "STS", "LDG", "STG", "BAR",
           "SYNCS", "UBLKCP")


# the stamped copy's slots: per warp, per MB, then the counts
PHASES = ("setup", "coarse", "barrier_and_strip", "centres", "fullpel_sad",
          "fullpel_reduce", "planes", "qpel_sad", "qpel_reduce", "outputs")
WARP_PHASES = PHASES[:3]


def ptxas(log):
    """The registers, shared memory and spill lines of a ptxas log."""
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "Compiling" in line]


def sass_counts(lib_path, out_dir, tag):
    """Disassemble a build into `out_dir`/`tag`.sass; per kernel its
    instruction count and opcode counts."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.sass"), "w") as fh:
        fh.write(text)
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                     r"(\.[A-Z0-9_.]+)?", line)
        if name and m:
            counts[name]["all"] += 1
            counts[name][m.group(1)] += 1
    return {k: {op: v[op] for op in ("all",) + OPCODES if v[op]}
            for k, v in counts.items()}


def baseline_module(tree):
    """An earlier tree's K4 and K5 wrapper module, loaded beside `me`,
    with that tree's kernels built and loaded under it. Returns (module, library
    path, build log)."""
    spec = importlib.util.spec_from_file_location(
        "baseline_me", os.path.join(tree, "h264lab_tpu_torch", "ops", "me.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path, log = cuda_build.build(os.path.join(tree, "h264lab_tpu_torch",
                                              "csrc", "me.cu"))
    if hasattr(mod, "_lib_handle"):       # a tree before `cuda_build.Library`
        mod._lib_handle = mod.load(path)
    else:
        mod._lib.use(path)
    return mod, path, log


def wrapper_ms(fn, args, reps):
    """Mean ms of `fn(*args)` over `reps` calls after a warm-up call (CUDA
    events)."""
    return chip_smoke._cuda_ms(lambda: fn(*args), reps)


def host_us(fn, args, reps):
    """Mean host us of one call of `fn(*args)` over `reps` calls issued
    back to back after a warm-up call (the device works behind them; the
    clock stops before the synchronization)."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def device_us(fn, args):
    """The hand kernels' launches in one call of `fn(*args)` and their
    device us (`chip_smoke.kernel_launches`)."""
    kernels, _ = chip_smoke.kernel_launches(lambda: fn(*args))
    return len(kernels), sum(us for _, us in kernels)


def phases(src, cases):
    """Mean cycles of each phase of the stamped copy `src` on each input
    [(what, args)]; from here on `me.motion_search_tiles` launches it."""
    import ctypes

    path, log = cuda_build.build(src)
    lib = me._lib.use(path)
    lib.h264lab_me_phases.argtypes = [ctypes.c_void_p]
    lib.h264lab_me_phases.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 16)()
    print(f"phases of {src}: {ptxas(log)}")
    out = {}
    for what, args in cases:
        for _ in range(2):           # a warm-up, then the measured launch
            cuda_build.check(lib.h264lab_me_phases(buf), "phases")
            me.motion_search_tiles(*args)
            torch.cuda.synchronize()
        cuda_build.check(lib.h264lab_me_phases(buf), "phases")
        mbs, warps, life = buf[10], buf[11], buf[12]
        cyc = {k: buf[i] / max(warps if k in WARP_PHASES else mbs, 1)
               for i, k in enumerate(PHASES)}
        out[what] = dict(cycles=cyc, mbs=mbs, warps=warps,
                         warp_life=life / warps)
        print(f"  {what}: {mbs} MBs, {warps} warps; cycles per warp "
              + ", ".join(f"{k} {cyc[k]:.0f}" for k in WARP_PHASES)
              + "; per MB " + ", ".join(f"{k} {cyc[k]:.0f}"
                                        for k in PHASES[3:])
              + f"; a warp's life {life / warps:.0f}")
    return out


def measure(name, mods, args, n_ops, reps):
    """One wrapper (`name` of ops/me.py: `motion_search_tiles` or
    `partition_tiles`) on one input: its outputs, bound, ms, kernel
    launches and device us; with an "old" module, the old wrapper's
    outputs against the new ones and the two timed in turns (old, new,
    new, old)."""
    fns = {tag: getattr(mod, name) for tag, mod in mods.items()}
    got = chip_smoke._search_outputs(fns["new"](*args))
    row = {}
    row["bound_ms"], row["bound_by"], _ = chip_smoke.search_bound(
        [x for x in args if isinstance(x, torch.Tensor)]
        + list(got.values()), n_ops)
    if "old" in fns:
        old = chip_smoke._search_outputs(fns["old"](*args))
        row["baseline_equal"] = set(old) == set(got) and all(
            torch.equal(old[k], v) for k, v in got.items())
        turns, hosts, dev = [], [], {}
        for tag in ("old", "new", "new", "old"):
            turns.append((tag, wrapper_ms(fns[tag], args, reps)))
            hosts.append((tag, host_us(fns[tag], args, reps)))
            if tag not in dev:
                dev[tag] = device_us(fns[tag], args)
        row["launches"], row["device_us"] = dev["new"]
        row["old_launches"], row["old_device_us"] = dev["old"]
        row["turns"], row["host_turns"] = turns, hosts
        row["ms"] = (turns[1][1] + turns[2][1]) / 2
        row["old_ms"] = (turns[0][1] + turns[3][1]) / 2
        row["host_us"] = (hosts[1][1] + hosts[2][1]) / 2
        row["old_host_us"] = (hosts[0][1] + hosts[3][1]) / 2
    else:
        row["ms"] = wrapper_ms(fns["new"], args, reps)
        row["host_us"] = host_us(fns["new"], args, reps)
        row["launches"], row["device_us"] = device_us(fns["new"], args)
    return row


def report(kernel, what, row, label):
    line = (f"  {kernel} on {what} {tuple(row['shape'])} {label}: "
            f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']} ({100 * row['bound_ms'] / row['ms']:.1f}%); "
            f"{row['launches']} kernel launch(es) a call, "
            f"{row['device_us']:.1f} us on the device, "
            f"{row['host_us']:.1f} us of host time a call")
    if "bound_ms_old_count" in row:
        line += (f"; on the older count: bound "
                 f"{row['bound_ms_old_count']:.4f} ms "
                 f"({100 * row['bound_ms_old_count'] / row['ms']:.1f}%)")
    if "turns" in row:
        line += (f"; in turns old, new, new, old: " + ", ".join(
            f"{ms:.4f}" for _, ms in row["turns"])
            + f" ms; old {row['old_ms']:.4f} ms "
            f"({100 * row['bound_ms'] / row['old_ms']:.1f}%), "
            f"new / old {row['ms'] / row['old_ms']:.3f}; old "
            f"{row['old_launches']} launch(es), {row['old_device_us']:.1f} "
            f"us on the device; host us a call in turns: " + ", ".join(
                f"{us:.1f}" for _, us in row["host_turns"])
            + f"; outputs equal: {row['baseline_equal']}")
    print(line)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="SRC")
    ap.add_argument("--sass", metavar="DIR")
    ap.add_argument("--phases", metavar="SRC")
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k4_bench: no CUDA device", file=sys.stderr)
        return 2
    label = f"[{card_label()}]"
    print(label)
    path, log = cuda_build.build(me._SRC)
    mods, paths = {"new": me}, {"new": path}
    result = dict(card=label, ptxas={"new": ptxas(log)}, k4={}, k5={})
    if opts.baseline:
        mods["old"], paths["old"], log = baseline_module(opts.baseline)
        result["ptxas"]["old"] = ptxas(log)
    for tag, lines in result["ptxas"].items():
        for line in lines:
            print(f"  {tag} ptxas: {line}")
    if opts.sass:
        result["sass"] = {}
        for tag, path in paths.items():
            result["sass"][tag] = sass_counts(path, opts.sass, tag)
            for fn, c in result["sass"][tag].items():
                print(f"  {tag} SASS {fn}: {c}")
    cases = []
    for what, seed, n, mbw, mbh, qp, lanes, rows, subpel in (
            chip_smoke.K4_CASES):
        args = chip_smoke.k4_case_args(seed, n, mbw, mbh, qp, lanes, rows,
                                       subpel)
        if opts.phases:
            cases.append((what, args))
        ops = chip_smoke.K4_OPS_SUBPEL if subpel else chip_smoke.K4_OPS_FULLPEL
        row = measure("motion_search_tiles", mods, args, n * mbw * mbh * ops,
                      opts.reps)
        row["shape"] = [n, mbw * mbh]
        result["k4"][what] = row
        report("K4", what, row, label)
        if subpel:
            k5 = chip_smoke.k5_args(args)
            row = measure("partition_tiles", mods, k5,
                          n * mbw * mbh * chip_smoke.K5_OPS_NEEDED_PER_MB,
                          opts.reps)
            row["shape"] = [n * mbw * mbh]
            row["bound_ms_old_count"] = max(
                row["bound_ms"], n * mbw * mbh * chip_smoke.K5_OPS_PER_MB
                / chip_smoke.INT32_OPS_PER_S * 1e3)
            result["k5"][what] = row
            report("K5", what, row, label)
            del k5
        del args
    if opts.phases:
        result["phases"] = phases(opts.phases, cases)
    del cases
    torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
