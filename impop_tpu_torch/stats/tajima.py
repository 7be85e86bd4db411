"""Tajima's D (port of :mod:`impop_tpu.stats.tajima`; tj_d.py formulas).

    a1 = Σ_{i=1}^{n-1} 1/i          a2 = Σ_{i=1}^{n-1} 1/i²
    b1 = (n+1)/(3(n-1))             b2 = 2(n²+n+3)/(9n(n-1))
    c1 = b1 - 1/a1                  c2 = b2 - (n+2)/(a1·n) + a2/a1²
    e1 = c1/a1                      e2 = c2/(a1² + a2)
    D  = (π - S/a1) / sqrt(e1·S + e2·S(S-1)),  NaN when S == 0 or n < 2.

The harmonic sums use exact partial sums up to 32 terms and asymptotic
series beyond, exactly as the JAX package does, so both agree to float32
round-off on every backend.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["TajimaConstants", "tajima_constants", "tajimas_d"]

_EULER_GAMMA = 0.5772156649015328606
_K0 = 32


class TajimaConstants(NamedTuple):
    a1: torch.Tensor
    a2: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    c1: torch.Tensor
    c2: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor


def _table(m: torch.Tensor, power: int) -> torch.Tensor:
    i = torch.arange(1, _K0 + 1, dtype=torch.float32, device=m.device)
    table = torch.cumsum(1.0 / (i if power == 1 else i * i), dim=0)
    small = torch.clamp(m.to(torch.int32), 0, _K0).to(torch.int64)
    return torch.where(small > 0, table[torch.clamp(small - 1, min=0)], 0.0)


def _harmonic(m: torch.Tensor) -> torch.Tensor:
    """H_m = Σ_{i=1}^{m} 1/i: table up to 32, then
    ln m + γ + 1/(2m) - 1/(12m²) + 1/(120m⁴)."""
    x = torch.clamp(m, min=float(_K0 + 1))
    inv = 1.0 / x
    inv2 = inv * inv
    tail = (torch.log(x) + _EULER_GAMMA
            + inv * (0.5 - inv * (1.0 / 12.0 - inv2 / 120.0)))
    return torch.where(m <= _K0, _table(m, 1), tail)


def _harmonic2(m: torch.Tensor) -> torch.Tensor:
    """Σ_{i=1}^{m} 1/i² = π²/6 - ψ'(m+1): table up to 32, then the
    trigamma asymptotic series."""
    x = torch.clamp(m + 1.0, min=_K0 + 1.0)
    inv = 1.0 / x
    inv2 = inv * inv
    trig = inv * (1.0 + inv * (0.5 + inv * (
        1.0 / 6.0 - inv2 * (1.0 / 30.0 - inv2 / 42.0))))
    tail = 1.6449340668482264 - trig
    return torch.where(m <= _K0, _table(m, 2), tail)


def tajima_constants(n) -> TajimaConstants:
    """The n-dependent constants (tj_d.py:53-60), vectorised over n."""
    nf = torch.as_tensor(n, dtype=torch.float32)
    a1 = _harmonic(nf - 1.0)
    a2 = _harmonic2(nf - 1.0)
    b1 = (nf + 1.0) / (3.0 * (nf - 1.0))
    b2 = 2.0 * (nf * nf + nf + 3.0) / (9.0 * nf * (nf - 1.0))
    c1 = b1 - 1.0 / a1
    c2 = b2 - (nf + 2.0) / (a1 * nf) + a2 / (a1 * a1)
    e1 = c1 / a1
    e2 = c2 / (a1 * a1 + a2)
    return TajimaConstants(a1, a2, b1, b2, c1, c2, e1, e2)


def tajimas_d(n, s, pi) -> torch.Tensor:
    """D = (π - S/a1) / sqrt(e1·S + e2·S(S-1)); NaN when S == 0 or n < 2
    (the drivers print NA)."""
    nf = torch.as_tensor(n, dtype=torch.float32)
    sf = torch.as_tensor(s, dtype=torch.float32, device=nf.device)
    pif = torch.as_tensor(pi, dtype=torch.float32, device=nf.device)
    c = tajima_constants(torch.clamp(nf, min=2.0))
    numerator = pif - sf / c.a1
    var = c.e1 * sf + c.e2 * sf * (sf - 1.0)
    denominator = torch.sqrt(torch.clamp(var, min=0.0))
    ok = (sf > 0) & (denominator > 0) & (nf >= 2)
    return torch.where(ok, numerator / torch.where(ok, denominator, 1.0),
                       torch.nan)
