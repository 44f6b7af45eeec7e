"""Beam extraction and ToF filtering in PyTorch (counterpart of
micro_quad_slam_tpu/ops/beams.py).

The reference walks 8 rows per column keeping a running (best, second)
pair (robust_col_dist_m, uav_local_nav.c:1320-1342).  Here, as in the JAX
module, invalid zones (0 / 0xFFFF / <=0.02 m after the mm->m conversion)
map to +inf and two masked min passes along the row axis give the second
smallest: element [1] of the sorted column when >=2 valid returns exist,
element [0] when exactly one, NaN when none.  Duplicate minima give
second == first, as the C pair tracking does.

All arithmetic is float32, matching the C `float` ops bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from micro_quad_slam_tpu_torch.utils.config import TofConfig

_F32 = np.float32


def _f(x) -> float:
    return float(_F32(x))


def extract_beams(grid_mm: torch.Tensor, tof: TofConfig = TofConfig()):
    """grid_mm int [..., 4, 8, 8] (the sensor's u16 millimetres, widened to
    int32 at the tensor boundary) -> (beams f32 [..., 4, 8], minima f32
    [..., 4]).  Rows are axis -2, columns axis -1."""
    mm = grid_mm.to(torch.int32)
    m = mm.to(torch.float32) * _f(0.001)
    valid = (mm != 0) & (mm != 0xFFFF) & (m > _f(tof.min_valid_m))
    m = m.clamp_max(_f(tof.max_range_m))
    inf = torch.full_like(m, math.inf)
    m = torch.where(valid, m, inf)
    # mask exactly ONE instance of the minimum (the first row holding it)
    first = m.amin(dim=-2)
    is_min = m == first.unsqueeze(-2)
    row_ids = torch.arange(m.shape[-2], device=m.device).reshape(-1, 1)
    first_min_row = torch.where(is_min, row_ids, m.shape[-2]).amin(dim=-2)
    mask_one = row_ids == first_min_row.unsqueeze(-2)
    second = torch.where(mask_one, inf, m).amin(dim=-2)
    count = valid.sum(dim=-2)
    nan = torch.full_like(first, math.nan)
    beams = torch.where(count >= 2, second,
                        torch.where(count == 1, first, nan))
    minima = torch.where(torch.isnan(beams), torch.full_like(beams, math.inf),
                         beams).amin(dim=-1)
    minima = torch.where(torch.isinf(minima), torch.full_like(minima, math.nan),
                         minima)
    return beams, minima


def tof_filter_weights(alpha: float) -> tuple:
    """The EMA's float32 weights (1 - a, a) as Python floats."""
    a = _F32(alpha)
    return _f(_F32(1.0) - a), _f(a)


def tof_filter_update(filt: torch.Tensor, minima: torch.Tensor,
                      alpha: float = 0.20) -> torch.Tensor:
    """NaN-aware EMA on per-direction minima (uav_local_nav.c:1430-1438):
    skip NaN samples, adopt the first sample directly, then
    (1-a)*filt + a*v in float32.

    The selects are value-identity on the lanes they keep (NaN lanes are
    overridden below) but pin the arithmetic to mul-then-add: a fusing
    compiler would otherwise be free to contract it into an fma, and the
    1-ulp skew breaks bit-equality of filt with the reference."""
    keep, a = tof_filter_weights(alpha)
    p1 = torch.where(filt == filt, keep * filt, minima)
    p2 = torch.where(minima == minima, a * minima, filt)
    blended = p1 + p2
    upd = torch.where(torch.isnan(filt), minima, blended)
    return torch.where(torch.isnan(minima), filt, upd)
