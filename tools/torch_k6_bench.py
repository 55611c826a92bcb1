"""K6, CAVLC symbolization (`h264lab_tpu_torch/csrc/symbolize.cu`), on the
CUDA card: its wrapper's time and host time, each of its three kernels'
device time, its bound, in turns against an earlier build, and what the
build holds.

    python tools/torch_k6_bench.py [--baseline DIR] [--sass DIR] [--reps N]
                                   [--only WHAT] [--no-real]

The inputs are first the real ones of three encodes on the card, recorded
at `mbscan.symbolize`: the first P step of 16 GOP lanes of 1920x1088 at
QP 33, speed 2, and the first P frame of one lane of it (as
`tools/torch_k78_bench.py` records them), and the base-mode slice of an
SVC base-mode IDR (SvcEncoder at 1920x1088 over 960x544 with inter-layer
prediction, QP 33, speed 2: K6's base-mode kind); then a seeded 1080p
base-mode slice (`utils.synthetic.sym_inputs`' levels) and
`chip_smoke.py`'s seeded K6 inputs (`K6_CASES`,
`utils.synthetic.sym_inputs`): 16 slices of 1080p in P and I slices (the
GOP lanes' steps), one 1080p slice with a row QP plan and with the
base_mode_flag bit (the sequential and SVC enhancement frames), the SVC
base layer, a mesh band and the small cases; and `K6_DENSE_CASE`, 16 P
slices of 1080p in which every block codes all its positions with levels
in both escapes and suffixLength climbing to 6. For each it prints K6's
wrapper ms (`symbolize.symbolize_tiles`, CUDA events over `--reps` calls
after a warm-up, as `chip_smoke.py`'s phase 19 takes it), the wrapper's
host us a call (the host clock over `--reps` calls issued back to back,
before the synchronization), the device us of each kernel of one call
(`chip_smoke.kernel_launches`: a trace of a second call), the bound
(`chip_smoke.k6_bytes` at `chip_smoke.HBM_BYTES_PER_S`) and the share of
it reached.

`--baseline DIR` names an earlier tree of the repository (for example
the parent commit, unpacked into a gitignored directory with `git
archive`). The script loads its K6 wrapper (`DIR/h264lab_tpu_torch/ops/
symbolize.py`, beside the current one) with its kernels (`DIR/
h264lab_tpu_torch/csrc/symbolize.cu` and its tables header, built too),
checks on every input that its outputs equal the current K6's, every
key and slot, and times the two wrappers in turns (old, new, new, old),
wrapper ms and host us alike.

`--sass DIR` disassembles each build (`cuobjdump -sass`) into DIR and
prints, per kernel, its SASS instruction count and the counts of the
opcodes that tell what holds it: local loads and stores (a stack frame),
shuffles, votes, branches and the divergence barriers, shared and global
loads and stores, byte permutes, population counts.

`--only WHAT` measures only the inputs whose name holds WHAT; `--no-real`
skips the encodes. An earlier tree without the base-mode kind is timed on
the other inputs only.

Needs a CUDA device; every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import inspect
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
from h264lab_tpu_torch.models import mbscan  # noqa: E402
from h264lab_tpu_torch.ops import cuda_build  # noqa: E402
from h264lab_tpu_torch.ops import symbolize as k6  # noqa: E402
from h264lab_tpu_torch.utils.device import card_label  # noqa: E402

# the opcodes counted in each K6 kernel's SASS
OPCODES = ("LDL", "STL", "SHFL", "VOTE", "BRA", "BSSY", "BSYNC", "WARPSYNC",
           "BAR", "LDS", "STS", "LDG", "STG", "LDGSTS", "ATOMG", "REDG",
           "PRMT", "POPC", "FLO", "SEL", "ISETP", "IADD3", "IMAD", "LOP3",
           "SHF")
KERNELS = ("sym_records_kernel", "sym_scan_kernel", "sym_codes_kernel")


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
            name = next((k for k in KERNELS if k in m.group(1)), m.group(1))
            if "ILb1E" in m.group(1):       # a base-mode instantiation
                name += "<true>"
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?", line)
        if name and m:
            counts[name]["all"] += 1
            counts[name][m.group(1)] += 1
    return {k: {op: v[op] for op in ("all",) + OPCODES if v[op]}
            for k, v in counts.items()}


def baseline_module(tree):
    """An earlier tree's K6 wrapper module, loaded beside `symbolize`, with
    that tree's kernels built and loaded under it. Returns (module, library
    path, build log)."""
    spec = importlib.util.spec_from_file_location(
        "baseline_symbolize", os.path.join(tree, "h264lab_tpu_torch", "ops",
                                           "symbolize.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path, log = cuda_build.build(os.path.join(tree, "h264lab_tpu_torch",
                                              "csrc", "symbolize.cu"))
    mod._lib.use(path)
    return mod, path, log


def host_us(fn, reps):
    """Mean host us of one call of `fn` over `reps` calls issued back to
    back after a warm-up call (the device works behind them; the clock
    stops before the synchronization)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def kernels_us(fn, want=3):
    """{kernel: device us} of one call of `fn`, from the fullest of up to
    six traces of a second call (`chip_smoke.kernel_launches`) that hold
    `want` kernels."""
    kernels, _ = chip_smoke.kernel_launches(fn, traces=6, want=want)
    return dict(kernels)


def wrapper_call(mod, args):
    """A call of `mod.symbolize_tiles` on `args`, the current
    `symbolize_args`' packing, cut to the arguments that the tree's
    wrapper takes (a tree before the base-mode kind takes no
    `base_mode`; its value here is then False)."""
    n = len(inspect.signature(mod.symbolize_tiles).parameters)
    if any(args[n:]):
        raise ValueError(f"{mod.__name__} does not take {args[n:]}")
    return lambda: mod.symbolize_tiles(*args[:n])


def measure(mods, args, reps):
    """K6 on one input's packed arguments: its bound, ms, host us and each
    kernel's device us; with an "old" module, the old wrapper's outputs
    against the new ones and the two timed in turns (old, new, new,
    old). A base-mode slice (two kernels) is timed on the new K6 only."""
    base_mode = bool(args[18])
    if base_mode:
        mods = {"new": mods["new"]}
    fns = {tag: wrapper_call(mod, args) for tag, mod in mods.items()}
    got = fns["new"]()
    want = 2 if base_mode else 3
    row = dict(bound_ms=chip_smoke.k6_bytes(args, got)
               / chip_smoke.HBM_BYTES_PER_S * 1e3, n_kernels=want)
    if "old" in fns:
        old = fns["old"]()
        row["baseline_equal"] = set(old) == set(got) and all(
            torch.equal(old[k], v) for k, v in got.items())
        del old
        turns, hosts, dev = [], [], {}
        for tag in ("old", "new", "new", "old"):
            turns.append((tag, chip_smoke._cuda_ms(fns[tag], reps)))
            hosts.append((tag, host_us(fns[tag], reps)))
            if tag not in dev:
                dev[tag] = kernels_us(fns[tag], want)
        row["kernels"], row["old_kernels"] = dev["new"], dev["old"]
        row["turns"], row["host_turns"] = turns, hosts
        row["ms"] = (turns[1][1] + turns[2][1]) / 2
        row["old_ms"] = (turns[0][1] + turns[3][1]) / 2
        row["host_us"] = (hosts[1][1] + hosts[2][1]) / 2
        row["old_host_us"] = (hosts[0][1] + hosts[3][1]) / 2
    else:
        row["ms"] = chip_smoke._cuda_ms(fns["new"], reps)
        row["host_us"] = host_us(fns["new"], reps)
        row["kernels"] = kernels_us(fns["new"], want)
    del got
    return row


def _kernels(k, want=3):
    return ", ".join(f"{name.replace('sym_', '').replace('_kernel', '')} "
                     f"{us:.1f}" for name, us in k.items()) + (
        f" (sum {sum(k.values()):.1f})" if len(k) == want else
        " (a trace lost a kernel)")


def report(what, row, label):
    line = (f"  K6 on {what} {tuple(row['shape'])} {label}: "
            f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({100 * row['bound_ms'] / row['ms']:.1f}%); device us "
            f"{_kernels(row['kernels'], row['n_kernels'])}; "
            f"{row['host_us']:.1f} us of host time a call")
    if "turns" in row:
        line += (f"; in turns old, new, new, old: " + ", ".join(
            f"{ms:.4f}" for _, ms in row["turns"])
            + f" ms; old {row['old_ms']:.4f} ms "
            f"({100 * row['bound_ms'] / row['old_ms']:.1f}%), new / old "
            f"{row['ms'] / row['old_ms']:.3f}; old device us "
            f"{_kernels(row['old_kernels'])}; host us a call in turns: "
            + ", ".join(f"{us:.1f}" for _, us in row["host_turns"])
            + f"; outputs equal: {row['baseline_equal']}")
    print(line, flush=True)


def record_base_mode():
    """The `symbolize` arguments of the base-mode slice of an SVC
    base-mode IDR (1920x1088 over 960x544, inter-layer prediction, QP 33,
    speed 2) on the card."""
    from h264lab_tpu_torch.config import EncoderConfig, RunConfig
    from h264lab_tpu_torch.models.svc import SvcEncoder
    from h264lab_tpu_torch.utils.synthetic import chessboard_sequence

    w, h, qp = chip_smoke.WIDTH, chip_smoke.HEIGHT, chip_smoke.QP
    enc = SvcEncoder(EncoderConfig(width=w, height=h, gop=chip_smoke.GOP,
                                   qp=qp, num_layers=2,
                                   inter_layer_pred_flag=True))
    calls = []
    with chip_smoke.recorded_calls("symbolize", calls):
        enc.encode(*next(iter(chessboard_sequence(w, h, 1))), RunConfig(
            qp_min=qp, qp_max=qp, encode_speed=2))
    torch.cuda.synchronize()
    call, = [c for c in calls if c[18]]
    return chip_smoke.to_device(call, "cpu")


def real_cases():
    """[(what, `symbolize` arguments)] of the real inputs."""
    import torch_k78_bench

    out = [(what, calls["symbolize"]) for what, calls in
           torch_k78_bench.record_real().items()]
    out.append(("SVC base-mode slice", record_base_mode()))
    torch.cuda.empty_cache()
    return out


def seeded_base_mode_call(seed, n, mbw, mbh):
    """`symbolize`'s arguments of seeded base-mode slices: the levels of
    `sym_inputs`' P slices."""
    from h264lab_tpu_torch.utils.synthetic import sym_inputs

    d = sym_inputs(seed, n, mbw, mbh, True)
    return (*(None,) * 10, *(torch.from_numpy(d[k]) for k in (
        "lev_inter", "cdc_lev", "cac_lev")), mbw, mbh, False, None, False,
        True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR")
    ap.add_argument("--sass", metavar="DIR")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", metavar="WHAT")
    ap.add_argument("--no-real", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k6_bench: no CUDA device", file=sys.stderr)
        return 2
    label = f"[{card_label()}]"
    print(label)
    path, log = cuda_build.build(k6.SRC)
    mods, paths = {"new": k6}, {"new": path}
    result = dict(card=label, ptxas={"new": ptxas(log)}, inputs={})
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
    calls = [] if opts.no_real else real_cases()
    calls.append(("1080p base-mode slice, seeded",
                  seeded_base_mode_call(73, 1, 120, 68)))
    cases = [c + (False,) for c in chip_smoke.K6_CASES]
    cases.append(chip_smoke.K6_DENSE_CASE + (True,))
    for what, seed, n, mbw, mbh, has_inter, plan, flag, dense in cases:
        calls.append((what, (seed, n, mbw, mbh, has_inter, plan, flag,
                             dense)))
    for what, call in calls:
        if opts.only and opts.only not in what:
            continue
        if len(call) == 8:            # a seeded K6_CASES input
            call = chip_smoke.k6_case_call(*call[:7], dense=call[7])
        args = mbscan.symbolize_args(*chip_smoke.to_device(call, "cuda"))
        row = measure(mods, args, opts.reps)
        row["shape"] = list(args[10].shape[:2])
        result["inputs"][what] = row
        report(what, row, label)
        del call, args
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
