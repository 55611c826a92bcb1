"""What the port carries across from the JAX package.

An encoder has no weights: its parameters are the configuration and the
constant tables. `config_from_reference` turns any object with the
`EncoderConfig` or `RunConfig` fields (duck-typed, so the JAX package's
own dataclasses work without being imported here) into the port's
dataclass. `check_constants` holds the port's tables, tuning constants,
lambda LUT, motion-search geometry, denoise gains and SVC's luma
upsampling filter against values the caller passes in as numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from h264lab_tpu_torch.config import EncoderConfig, FrameType, RunConfig
from h264lab_tpu_torch.ops import (denoise, me, qpel, resample, tables,
                                   tables_cavlc, tuning)

# the motion-search and sub-pel geometry (window sizes, radii, guard ring)
ME_GEOMETRY = ("COARSE_R4", "REFINE_R", "WIN_M", "WIN_S", "ALN_S", "SUB",
               "MAX_CAND_FP")


def config_from_reference(obj):
    """EncoderConfig or RunConfig of the port with the field values of
    `obj`, which must carry every field of one of the two."""
    for cls in (EncoderConfig, RunConfig):
        names = [f.name for f in dataclasses.fields(cls)]
        if all(hasattr(obj, n) for n in names):
            kw = {n: getattr(obj, n) for n in names}
            if cls is RunConfig:
                kw["frame_type"] = FrameType(int(kw["frame_type"]))
            return cls(**kw)
    raise TypeError(f"{type(obj).__name__} has neither the EncoderConfig "
                    "nor the RunConfig fields")


def constants() -> dict:
    """The port's constants by name: spec tables as `tables.X` /
    `tables_cavlc.X`, tuning constants as `tuning.X` (the partition
    penalties among them), `LAMBDA_ME`, the ME geometry as `me.X`, the
    guard ring as `qpel.GUARD`, the denoise gain table as
    `denoise.GAIN_Q8` and SVC's 16-phase luma upsampling filter as
    `resample.FILTER16_LUMA`."""
    out = {}
    for prefix, mod in (("tables", tables), ("tables_cavlc", tables_cavlc)):
        for name, val in vars(mod).items():
            if name[:1].isupper() and isinstance(val, np.ndarray):
                out[f"{prefix}.{name}"] = val
    for name, val in vars(tuning).items():
        if name[:1].isupper() and isinstance(val, int):
            out[f"tuning.{name}"] = np.asarray(val)
    out["LAMBDA_ME"] = me.LAMBDA_ME
    for name in ME_GEOMETRY:
        out[f"me.{name}"] = np.asarray(getattr(me, name))
    out["qpel.GUARD"] = np.asarray(qpel.GUARD)
    out["denoise.GAIN_Q8"] = denoise.GAIN_Q8
    out["resample.FILTER16_LUMA"] = resample.FILTER16_LUMA
    return out


def check_constants(reference: Mapping[str, np.ndarray]) -> None:
    """Raise ValueError unless `reference` names exactly the port's
    constants (see `constants`) with equal values."""
    ours = constants()
    missing = sorted(set(ours) ^ set(reference))
    if missing:
        raise ValueError(f"constant sets differ: {missing}")
    bad = [k for k in ours
           if not np.array_equal(np.asarray(ours[k]),
                                 np.asarray(reference[k]))]
    if bad:
        raise ValueError(f"constants differ from the reference: {bad}")
