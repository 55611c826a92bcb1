"""The port's deblocking filter against the JAX package's, on the CPU.

`h264lab_tpu_torch.models.mbscan.deblock_frame` on CPU tensors runs its
plain version (`deblock_frame_plain`); on CUDA tensors it launches K2
(`csrc/deblock.cu`), which `tests/test_torch_cuda.py` and `chip_smoke.py`
hold against that plain version on the card. Here, on seeded inputs
(`utils.synthetic.deblock_inputs`: bS 0 to 4, flat areas for the strong
filter, QPs below 16 where alpha is 0, per-frame and per-MB QPs, a band's
first row and column unavailable; 4 x 3, 3 x 5 and 1 x 6 MBs, one and
three frames):
- the port's `deblock_frame` equals JAX's `deblock_frame`, frame by frame;
- `deblock.edge_qps`, which builds K2's QP arguments, gives per-frame QPs
  the same per-edge arrays as per-MB QPs that repeat them, and the plain
  filter the same output either way;
- CPU tensors never reach K2: a CPU GopBandEncoder step launches nothing,
  and `deblock_tiles` refuses CPU tensors.
Tolerance: exact equality (integer arithmetic).
"""

import jax
import numpy as np
import pytest
import torch

from h264lab_tpu.models import mbscan as jmb
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.models import mbscan as tmb
from h264lab_tpu_torch.ops import deblock
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
from h264lab_tpu_torch.parallel.gop import GopBandEncoder
from h264lab_tpu_torch.utils.synthetic import chessboard_sequence, \
    deblock_inputs

_jax_deblock = jax.jit(jmb.deblock_frame, static_argnums=(11, 12))

# (seed, frames, mb_width, mb_height, qp, per-MB QPs, band edges)
CASES = [
    (1, 1, 4, 3, 30, False, False),
    (2, 3, 4, 3, 14, True, True),       # QPs 4..24: alpha 0 below 16
    (3, 3, 3, 5, 40, False, True),
    (4, 1, 3, 5, 22, True, False),
    (5, 3, 1, 6, 36, True, True),       # one MB wide
    (6, 1, 1, 6, 48, False, False),
]


def _inputs(case):
    seed, n, mbw, mbh, qp, per_mb, band = case
    return deblock_inputs(seed, n, mbw, mbh, qp, per_mb_qp=per_mb,
                          band=band), mbw, mbh


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_deblock_frame_matches_jax(case):
    d, mbw, mbh = _inputs(case)
    t = _torch(d)
    bs = torch.cat(tmb._frame_bs(t["sel"], t["nnz_blk"], t["mv4_y"],
                                 t["mv4_x"], t["avail_top"], t["avail_left"],
                                 mbw, mbh))
    assert set(bs.unique().tolist()) == {0, 1, 2, 3, 4}
    got = tmb.deblock_frame(**t, mb_width=mbw, mb_height=mbh)
    for i in range(d["sel"].shape[0]):
        want = _jax_deblock(
            d["recon_y"][i], d["recon_u"][i], d["recon_v"][i], d["sel"][i],
            d["nnz_blk"][i], d["mv4_y"][i], d["mv4_x"][i], d["qp"][i],
            d["qpc"][i], d["avail_top"], d["avail_left"], mbw, mbh)
        for plane, a, b in zip("yuv", want, got):
            assert b.dtype == torch.uint8
            np.testing.assert_array_equal(np.asarray(a), b[i].numpy(),
                                          err_msg=f"frame {i} {plane}")
    assert any(not torch.equal(a, t[k]) for a, k in zip(
        got, ("recon_y", "recon_u", "recon_v")))      # the filter ran


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[5]],
                         ids=lambda c: f"seed{c[0]}")
def test_edge_qps_per_frame_equal_per_mb(case):
    d, mbw, mbh = _inputs(case)
    t = _torch(d)
    n, nmb = t["sel"].shape
    per_frame = deblock.edge_qps(t["qp"], t["qpc"], n, mbw, mbh)
    per_mb = deblock.edge_qps(t["qp"][:, None].expand(n, nmb),
                              t["qpc"][:, None].expand(n, nmb), n, mbw, mbh)
    for a, b, q, edges in zip(per_frame, per_mb, ("qp", "qp", "qpc", "qpc"),
                              (4, 4, 2, 2)):
        assert a.dtype == torch.int32 and a.shape == (n, nmb, edges)
        assert torch.equal(a, b)
        assert torch.equal(a, t[q][:, None, None].expand(n, nmb, edges))
    want = tmb.deblock_frame(**t, mb_width=mbw, mb_height=mbh)
    t["qp"] = t["qp"][:, None].expand(n, nmb)
    t["qpc"] = t["qpc"][:, None].expand(n, nmb)
    got = tmb.deblock_frame(**t, mb_width=mbw, mb_height=mbh)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_edge_qps_per_mb_average():
    d, mbw, mbh = _inputs(CASES[1])
    q = d["qp"].reshape(3, mbh, mbw).astype(np.int64)
    qv, qh, _, _ = deblock.edge_qps(torch.from_numpy(d["qp"]),
                                    torch.from_numpy(d["qpc"]), 3, mbw, mbh)
    left = np.concatenate([q[:, :, :1], q[:, :, :-1]], axis=2)
    top = np.concatenate([q[:, :1], q[:, :-1]], axis=1)
    for got, nb in ((qv, left), (qh, top)):
        got = got.numpy().reshape(3, mbh, mbw, 4)
        np.testing.assert_array_equal(got[..., 0], (q + nb + 1) // 2)
        np.testing.assert_array_equal(got[..., 1:], np.repeat(
            q[..., None], 3, axis=3))


def test_cpu_tensors_never_reach_k2():
    cfg = EncoderConfig(width=64, height=48, gop=3, qp=33)
    run = RunConfig(qp_min=33, qp_max=33, encode_speed=2)
    enc = GopBandEncoder(cfg, n_gop=2, device="cpu")
    frames = list(chessboard_sequence(64, 48, 3))
    before = dict(LAUNCH_COUNTS)
    enc.stage_times = {}
    for t in range(2):                  # an IDR step, then a P step
        res = enc.encode_step([frames[t], frames[t + 1]], run)
        assert all(len(r.payload) > 0 for r in res)
    assert "deblock" in enc.stage_times           # the stage ran
    assert LAUNCH_COUNTS == before and LAUNCH_COUNTS["deblock"] == 0
    d, mbw, mbh = _inputs(CASES[0])
    t = _torch(d)
    q = deblock.edge_qps(t["qp"], t["qpc"], 1, mbw, mbh)
    bs = torch.zeros((1, mbw * mbh, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        deblock.deblock_tiles(t["recon_y"], t["recon_u"], t["recon_v"], bs,
                              bs, *q, mbw, mbh)
    assert LAUNCH_COUNTS == before
