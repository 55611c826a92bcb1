"""The port's command line against the JAX package's, and the denoise
filter against JAX's.

`h264lab_tpu_torch.cli.main` with `--device cpu` must write the same
output file, byte for byte, as `h264lab_tpu.cli.main` with the same flags,
on the synthetic input (`--gen`) at 64x64 and four frames: at the default
speed 0 and at speed 0 with bitrate mode (`--kbps`), two slice bands
(`--threads 2`), the dyadic temporal-layer schedule (`--temporal-layers
2`) and temporal denoising (`--denoise`); with `--psnr` both print the
same quality report, and the stream decodes to four frames. The denoise
filter equals JAX's on random planes.
"""

import numpy as np
import pytest
import torch

from h264lab_tpu import cli as jcli
from h264lab_tpu.decoder.decoder import H264Decoder
from h264lab_tpu.ops import denoise as jdn
from h264lab_tpu_torch import cli as tcli
from h264lab_tpu_torch.ops import denoise as tdn

BASE = ["--gen", "--size", "64x64", "--maxframes", "4", "--speed", "0"]


@pytest.mark.parametrize("flags", [
    ["--psnr"], ["--kbps", "60"], ["--threads", "2"],
    ["--temporal-layers", "2"], ["--denoise"]],
    ids=["default", "kbps", "threads2", "temporal2", "denoise"])
def test_cli_output_equals_jax(tmp_path, capsys, flags):
    want_path, got_path = tmp_path / "jax.264", tmp_path / "port.264"
    assert jcli.main(BASE + flags + ["--output", str(want_path)]) == 0
    want_out = capsys.readouterr().out
    assert tcli.main(BASE + flags + ["--output", str(got_path),
                                     "--device", "cpu"]) == 0
    got_out = capsys.readouterr().out
    want = want_path.read_bytes()
    assert len(want) > 0 and got_path.read_bytes() == want
    assert len(H264Decoder().decode(want)) == 4       # a playable stream
    if "--psnr" in flags:          # the report; the first line is timing
        assert got_out.splitlines()[1:] == want_out.splitlines()[1:]
        assert "PSNR" in got_out or "psnr" in got_out.lower()


def test_cli_defaults_and_device_flag():
    jp, tp = jcli.build_parser(), tcli.build_parser()
    jd, td = vars(jp.parse_args([])), vars(tp.parse_args([]))
    assert td.pop("device") is None            # the card
    assert td == jd
    assert tcli.main([]) == 1                  # no input: help, exit 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_denoise_plane_equals_jax(seed):
    """Random planes, and a previous plane near the current one (blends
    happen) and far from it (none do), odd sizes included."""
    rng = np.random.default_rng(seed)
    h, w = (37, 50) if seed else (16, 16)
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    for prev in (rng.integers(0, 256, (h, w), dtype=np.uint8),
                 np.clip(cur.astype(np.int32)
                         + rng.integers(-6, 7, (h, w)), 0, 255
                         ).astype(np.uint8)):
        want = np.asarray(jdn.denoise_plane(cur, prev))
        got = tdn.denoise_plane(torch.from_numpy(cur), torch.from_numpy(prev))
        np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, cur)       # the near plane blends
