"""Exact-decimal integer kernels (torch port of ``presto_tpu/ops/decimal.py``).

Trino models short decimals as unscaled int64 with static (precision, scale)
(``core/trino-spi/.../type/DecimalType.java``, rounding in
``spi/type/Decimals.java``: HALF_UP = round half away from zero).  All money
math here is int64 tensors — never floats — so aggregates are bit-exact.
"""

from __future__ import annotations

import torch

POW10 = [10**i for i in range(19)]


def rescale(x: torch.Tensor, from_scale: int, to_scale: int) -> torch.Tensor:
    """Change decimal scale; scale-down rounds half away from zero."""
    if to_scale == from_scale:
        return x
    if to_scale > from_scale:
        return x * POW10[to_scale - from_scale]
    return div_round_half_up(x, POW10[from_scale - to_scale])


def div_round_half_up(num: torch.Tensor, den) -> torch.Tensor:
    """num / den rounded half away from zero (Decimals.java HALF_UP).

    Both operands are made non-negative before the division, so torch's
    floor division and truncation agree."""
    num = num.to(torch.int64)
    if not isinstance(den, torch.Tensor):
        den = torch.tensor(den, dtype=torch.int64, device=num.device)
    den = den.to(torch.int64)
    sign = torch.where((num < 0) ^ (den < 0), -1, 1)
    an = num.abs()
    ad = den.abs().clamp_min(1)  # caller guards div-by-zero → null
    q = torch.div(an, ad, rounding_mode="floor")
    rem = an - q * ad
    q = q + (rem * 2 >= ad).to(torch.int64)
    return sign * q


def decimal_div(x: torch.Tensor, x_scale: int, y: torch.Tensor, y_scale: int,
                result_scale: int) -> torch.Tensor:
    """x/y at result_scale with HALF_UP (Trino DecimalOperators.divide:
    rescale numerator by 10^(result_scale + y_scale - x_scale), divide,
    round)."""
    shift = result_scale + y_scale - x_scale
    num = x.to(torch.int64)
    if shift > 0:
        num = num * POW10[shift]
    elif shift < 0:
        num = div_round_half_up(num, POW10[-shift])
    return div_round_half_up(num, y)
