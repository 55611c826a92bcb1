"""CAVLC residual entropy coding (spec 9.2), batched over 4x4 blocks.

PyTorch counterpart of `h264lab_tpu/ops/cavlc.py`: the complete VLC
symbol expansion of every residual block in parallel, as fixed-slot
`(n, 34)` (value, nbits) arrays whose in-order concatenation (dropping
nbits == 0 slots) is the block's exact bitstream.

Differences of form, not of result:
- table lookups are plain indexing (the JAX module used one-hot sums
  because elementwise gathers are slow on a TPU; every index here is in
  range, so both give the same values);
- the reverse-scan compaction of nonzero levels is one scatter instead of
  a (n, 16, 16) one-hot reduction;
- the adaptive level-suffix scan is a Python loop over the 16 positions,
  vectorized over all blocks (it stays sequential per block).

Values are int32 carrying the uint32 bit pattern (every CAVLC value fits
in 31 bits, so they are also non-negative).

Symbol slot layout per block:
  0      coeff_token
  1      trailing-one sign bits (packed into one symbol)
  2..17  level codes (reverse scan order)
  18     total_zeros
  19..33 run_before codes
"""

from __future__ import annotations

import functools

import torch

from h264lab_tpu_torch.ops import tables_cavlc as tc

N_SLOTS = 34
I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    def t(a):
        return torch.as_tensor(a.reshape(-1), dtype=I32, device=device)
    return dict(ct_len=t(tc.COEFF_TOKEN_LEN), ct_val=t(tc.COEFF_TOKEN_VAL),
                tz_len=t(tc.TOTAL_ZEROS_LEN), tz_val=t(tc.TOTAL_ZEROS_VAL),
                cz_len=t(tc.TOTAL_ZEROS_CDC_LEN),
                cz_val=t(tc.TOTAL_ZEROS_CDC_VAL),
                rb_len=t(tc.RUN_BEFORE_LEN), rb_val=t(tc.RUN_BEFORE_VAL))


def nc_context(nc: torch.Tensor) -> torch.Tensor:
    """nC -> coeff_token table index (spec 9.2.1): 0,1,2 for [0,2), [2,4),
    [4,8); 3 = FLC nC >= 8; 4 = chroma DC (nC == -1)."""
    return torch.where(
        nc < 0, 4,
        torch.where(nc < 2, 0, torch.where(nc < 4, 1,
                                           torch.where(nc < 8, 2, 3))))


def _level_code_bits(lc: torch.Tensor, sl: torch.Tensor):
    """VLC of levelCode `lc` at suffixLength `sl` (spec 9.2.2.1 inverted):
    '0'*prefix + '1' + suffix as one symbol of <= 32 bits."""
    one = torch.ones_like(lc)
    slc = torch.clamp(sl, min=0)
    prefix = lc >> slc
    mask = (one << slc) - 1
    a_len = lc + 1                                     # sl == 0, lc < 14
    b_val = (1 << 4) | (lc - 14)                       # 14 <= lc < 30
    c_val = (one << sl) | (lc & mask)                  # sl > 0, prefix < 15
    c_len = prefix + 1 + sl
    esc_base = (15 << slc) + torch.where(sl == 0, 15, 0)
    rem = lc - esc_base
    d_val = (1 << 12) | rem                            # escape, 12-bit suffix
    e_val = (1 << 13) | (rem - 4096)                   # escape, 13-bit suffix

    use_a = (sl == 0) & (lc < 14)
    use_b = (sl == 0) & (lc >= 14) & (lc < 30)
    use_c = (sl > 0) & (prefix < 15)
    use_d = ~(use_a | use_b | use_c) & (rem < 4096)
    val = torch.where(use_a, one, torch.where(
        use_b, b_val, torch.where(use_c, c_val,
                                  torch.where(use_d, d_val, e_val))))
    nbits = torch.where(use_a, a_len, torch.where(
        use_b, 19, torch.where(use_c, c_len, torch.where(use_d, 28, 30))))
    return val.to(I32), nbits.to(I32)


def encode_blocks(levels: torch.Tensor, nc: torch.Tensor, max_coeff):
    """CAVLC-encode a batch of blocks.

    levels (n, 16) int, zig-zag order (15-coefficient AC blocks in slots
    0..14, chroma DC in slots 0..3); nc (n,) nC context (-1 for chroma DC);
    max_coeff 16, 15 or 4, or a per-block (n,) tensor of 15/16.

    Returns vals (n, 34) int32, lens (n, 34) int32, total_coeff (n,) int32.
    """
    n = levels.shape[0]
    dev = levels.device
    tb = _tables(dev)
    levels = levels.to(I32)
    scan_pos = torch.arange(16, dtype=I32, device=dev)
    if isinstance(max_coeff, int):
        mc = torch.full((n,), max_coeff, dtype=I32, device=dev)
    else:
        mc = max_coeff.to(I32)
    lv = torch.where(scan_pos[None, :] < mc[:, None], levels, 0)

    nonzero = lv != 0
    total = nonzero.sum(1, dtype=I32)                   # TotalCoeff
    # reverse-scan compaction: rank[p] = number of nonzeros after p, the
    # position of a nonzero at p in reverse order; zeros go to a dump
    # column that is cut off
    nz_i = nonzero.to(I32)
    rank = nz_i.flip(1).cumsum(1, dtype=I32).flip(1) - nz_i
    tgt = torch.where(nonzero, rank, 16).long()
    lev = torch.zeros((n, 17), dtype=I32, device=dev).scatter_(
        1, tgt, lv)[:, :16]
    pos = torch.zeros((n, 17), dtype=I32, device=dev).scatter_(
        1, tgt, scan_pos.expand(n, 16).contiguous())[:, :16]
    k_valid = scan_pos[None, :] < total[:, None]

    # TrailingOnes: leading run of |level| == 1 in reverse order, <= 3
    is_one = (lev.abs() == 1) & k_valid
    c0 = is_one[:, 0]
    c1 = c0 & is_one[:, 1]
    c2 = c1 & is_one[:, 2]
    t1 = torch.minimum(c0.to(I32) + c1.to(I32) + c2.to(I32), total)

    ct_idx = (nc_context(nc) * 17 + total) * 4 + t1
    ct_val = tb["ct_val"][ct_idx]
    ct_len = tb["ct_len"][ct_idx]

    # trailing-one signs, highest frequency first, as one symbol
    sign_bits = (lev < 0).to(I32)
    t1_sign_val = torch.zeros((n,), dtype=I32, device=dev)
    for k in range(3):
        t1_sign_val = torch.where(k < t1, (t1_sign_val << 1) | sign_bits[:, k],
                                  t1_sign_val)

    # levels (non-trailing-ones), reverse scan order: the adaptive suffix
    # length is CAVLC's one sequential element
    sl = torch.where((total > 10) & (t1 < 3), 1, 0).to(I32)
    lv_v = torch.empty((n, 16), dtype=I32, device=dev)
    lv_l = torch.empty((n, 16), dtype=I32, device=dev)
    for k in range(16):
        l = lev[:, k]
        is_lvl = k_valid[:, k] & (k >= t1)
        abs_l = l.abs()
        lc = 2 * (abs_l - 1) + (l < 0).to(I32)
        lc = torch.where((t1 == k) & (t1 < 3), lc - 2, lc)
        val, nbits = _level_code_bits(torch.clamp(lc, min=0), sl)
        sl_next = torch.where(sl == 0, 1, sl)
        thresh = 3 << torch.clamp(sl_next - 1, min=0)
        sl_next = torch.minimum(torch.where(abs_l > thresh, sl_next + 1,
                                            sl_next), torch.full_like(sl, 6))
        sl = torch.where(is_lvl, sl_next, sl)
        lv_v[:, k] = torch.where(is_lvl, val, 0)
        lv_l[:, k] = torch.where(is_lvl, nbits, 0)

    # total_zeros
    total_zeros = torch.where(total > 0, pos[:, 0] + 1 - total, 0)
    if isinstance(max_coeff, int) and max_coeff == 4:
        idx = torch.clamp(total, max=3) * 4 + torch.clamp(total_zeros, max=3)
        tz_val, tz_len = tb["cz_val"][idx], tb["cz_len"][idx]
    else:
        idx = torch.clamp(total, max=15) * 16 + total_zeros
        tz_val, tz_len = tb["tz_val"][idx], tb["tz_len"][idx]
    has_tz = (total > 0) & (total < mc)
    tz_val = torch.where(has_tz, tz_val, 0)
    tz_len = torch.where(has_tz, tz_len, 0)

    # run_before, batched over the 15 coefficient positions
    ks = scan_pos[None, :15]
    zeros_left = pos[:, :15] - (total[:, None] - 1 - ks)
    run = pos[:, :15] - pos[:, 1:16] - 1
    need = (ks < total[:, None] - 1) & (zeros_left > 0) & (total[:, None] > 0)
    rb_idx = torch.clamp(zeros_left, 0, 7) * 15 + torch.clamp(run, 0, 14)
    rb_vals = torch.where(need, tb["rb_val"][rb_idx], 0)
    rb_lens = torch.where(need, tb["rb_len"][rb_idx], 0)

    vals = torch.cat([ct_val[:, None], t1_sign_val[:, None], lv_v,
                      tz_val[:, None], rb_vals], dim=1)
    lens = torch.cat([ct_len[:, None], t1[:, None], lv_l,
                      tz_len[:, None], rb_lens], dim=1)
    return vals.to(I32), lens.to(I32), total
