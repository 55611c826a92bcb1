"""The mesh's shards run at once, one worker thread per mesh entry
(`h264lab_tpu_torch.parallel.gop.ShardWorkers`), on `["cpu"] * n` meshes:

- every shard's `FrameStages.run` of a (2, 2) mesh step is in flight at
  once: each waits at a barrier of four, which shards run in turns would
  break (after its 30 s timeout), while their `sym` stages are issued one
  at a time (the workers' issue lock), and the lanes' bytes still equal
  the unsharded encoder's; the workers' host intervals of the step all
  overlap; `ShardedIntraEncoder.encode_batch` runs each entry on its own
  worker, its encode under the workers' issue lock, to the unsharded
  outputs;
- an exception in one shard, or in two, is raised by `encode_step_async`
  and by `encode_step` (the second as a note on the first), and the
  encoder's counters do not advance;
- `cuda_build.Library` builds and loads once when eight threads call it at
  once (`cuda_build.build` replaced by a counting stub that returns the C
  library, so no nvcc is needed), and `cuda_build.count_launch` loses no
  count of K1's or K6's counter under thirty-two threads with a short
  switch interval.
"""

import ctypes
import ctypes.util
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.models import mbscan
from h264lab_tpu_torch.models.stages import FrameStages
from h264lab_tpu_torch.ops import cuda_build
from h264lab_tpu_torch.parallel import gop as tgop
from h264lab_tpu_torch.parallel import sharding as tsh
from h264lab_tpu_torch.utils.synthetic import chessboard_sequence

W, H = 64, 64
CFG = EncoderConfig(width=W, height=H, gop=3, qp=30, slice_bands=2)
RUN = RunConfig(qp_min=30, qp_max=30, encode_speed=2)


def _lanes(t, n_gop=2):
    frames = list(chessboard_sequence(W, H, t + n_gop))
    return frames[t:t + n_gop]


def _mesh_encoder(shape=(2, 2)):
    return tgop.GopBandEncoder(CFG, n_gop=2, mesh=tgop.make_mesh(
        *shape, ["cpu"] * (shape[0] * shape[1])))


def _at_barrier(monkeypatch, owner, name, n):
    """Make `owner.name` wait at a barrier of n before it runs; returns the
    barrier."""
    barrier = threading.Barrier(n, timeout=30)
    fn = getattr(owner, name)

    def waiting(*args, **kwargs):
        barrier.wait()
        return fn(*args, **kwargs)

    monkeypatch.setattr(owner, name, waiting)
    return barrier


def test_mesh_shards_are_in_flight_together(monkeypatch):
    flat = tgop.GopBandEncoder(CFG, n_gop=2, device="cpu")
    want = [flat.encode_step(_lanes(t), RUN) for t in range(2)]
    barrier = _at_barrier(monkeypatch, FrameStages, "run", 4)
    # the shards issue one stage at a time (the workers' issue lock)
    symbolize, active, most = mbscan.symbolize, [0], [0]

    def counting(*args, **kwargs):
        active[0] += 1
        most[0] = max(most[0], active[0])
        try:
            return symbolize(*args, **kwargs)
        finally:
            active[0] -= 1

    monkeypatch.setattr(mbscan, "symbolize", counting)
    enc = _mesh_encoder()
    for t in range(2):                               # IDR, then P
        got = enc.encode_step(_lanes(t), RUN)
        assert not barrier.broken
        assert most[0] == 1
        intervals = enc.workers.intervals
        assert len(intervals) == 4
        assert all(0 <= a < b for a, b in intervals)
        # every shard started before any shard ended
        assert max(a for a, _ in intervals) < min(b for _, b in intervals)
        assert [r.payload for r in got] == [r.payload for r in want[t]]
        assert [r.frame_type for r in got] == [["IDR", "P"][t]] * 2


def test_sharded_intra_entries_run_on_their_workers(monkeypatch):
    rng = np.random.default_rng(5)
    tiles = [rng.integers(0, 256, (2, 4, 8, t, t), dtype=np.uint8)
             for t in (16, 8, 8)]
    want = tsh.ShardedIntraEncoder(tsh.make_mesh(1, 1, ["cpu"]), 4,
                                   2).encode_batch(*tiles, 30, 29)
    enc = tsh.ShardedIntraEncoder(tsh.make_mesh(2, 2, ["cpu"] * 4), 4, 2)
    threads = []
    encode = mbscan.encode_intra_frames

    def recording(*args):
        threads.append((threading.current_thread().name,
                        enc.workers.issue_lock.locked()))
        return encode(*args)

    monkeypatch.setattr(mbscan, "encode_intra_frames", recording)
    got = enc.encode_batch(*tiles, 30, 29)
    # one call on each entry's worker, each issued under the issue lock
    assert len({name for name, _ in threads}) == 4
    assert all(name.startswith("mesh-entry-") and held
               for name, held in threads)
    assert set(got) == set(want)
    for key, val in want.items():
        assert np.array_equal(got[key].numpy(), val.numpy()), key


@pytest.mark.parametrize("failing", [(2,), (1, 3)])
def test_a_failing_shard_raises_from_the_step(monkeypatch, failing):
    enc = _mesh_encoder()
    bad = {id(enc.shards[k].stages): k for k in failing}
    run = FrameStages.run

    def maybe_fail(self, *args, **kwargs):
        if id(self) in bad:
            raise RuntimeError(f"injected in shard {bad[id(self)]}")
        return run(self, *args, **kwargs)

    monkeypatch.setattr(FrameStages, "run", maybe_fail)
    with pytest.raises(RuntimeError, match="injected in shard") as err:
        enc.encode_step_async(_lanes(0), RUN)
    notes = getattr(err.value, "__notes__", [])
    assert len(notes) == len(failing) - 1
    assert enc.step_idx == 0 and enc.frame_num == 0
    with pytest.raises(RuntimeError, match="injected in shard"):
        enc.encode_step(_lanes(0), RUN)
    assert enc.step_idx == 0
    monkeypatch.undo()
    # the workers still serve the encoder
    res = enc.encode_step(_lanes(0), RUN)
    assert [r.frame_type for r in res] == ["IDR", "IDR"]


def test_the_loader_builds_once_under_concurrent_first_use(monkeypatch):
    libc = ctypes.util.find_library("c")
    assert libc
    builds = []

    def build(src):
        builds.append(src)
        time.sleep(0.05)              # widen the window for a second build
        return Path(libc), ""

    monkeypatch.setattr(cuda_build, "build", build)
    lib = cuda_build.Library(cuda_build.CSRC / "none.cu",
                             {"abs": ([ctypes.c_int], ctypes.c_int)})
    start = threading.Barrier(8, timeout=30)
    got = [None] * 8

    def first_use(k):
        start.wait()
        got[k] = lib()

    threads = [threading.Thread(target=first_use, args=(k,))
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(builds) == 1
    assert all(g is got[0] for g in got)
    assert got[0].abs(-3) == 3                 # the signature was set


def test_launch_counts_are_exact_under_threads(monkeypatch):
    monkeypatch.setitem(cuda_build.LAUNCH_COUNTS, "bitpack", 0)
    monkeypatch.setitem(cuda_build.LAUNCH_COUNTS, "symbolize", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        # K1's counter and K6's, which the shards' sym and pack stages
        # bump from their threads
        threads = [threading.Thread(target=lambda k=k: [
            cuda_build.count_launch(("bitpack", "symbolize")[k % 2])
            for _ in range(2000)]) for k in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert cuda_build.LAUNCH_COUNTS["bitpack"] == 16 * 2000
    assert cuda_build.LAUNCH_COUNTS["symbolize"] == 16 * 2000
