"""Closed-form Black–Scholes oracle (the JAX package's ``ops/analytic.py``,
``black_scholes_price`` only). Pure and broadcastable over tensors; floats
are taken as float64 scalars."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True, slots=True)
class AnalyticPrices:
    """Discounted put/call prices with intrinsics and convexities (time value)."""

    put: torch.Tensor
    call: torch.Tensor
    put_intrinsic: torch.Tensor
    call_intrinsic: torch.Tensor
    put_convexity: torch.Tensor
    call_convexity: torch.Tensor


def _norm_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def black_scholes_price(
    spot: torch.Tensor | float,
    strike: torch.Tensor | float,
    maturity: torch.Tensor | float,
    rate: torch.Tensor | float,
    div_yield: torch.Tensor | float,
    vol: torch.Tensor | float,
) -> AnalyticPrices:
    """European put/call under GBM: Black formula on the forward.

    F = S·e^{(r−q)T}, df = e^{−rT}; call = df·(F·N(d1) − K·N(d2)), put via
    parity. Intrinsic is the discounted forward-intrinsic df·max(±(F−K), 0).
    """
    s, k, t, r, q, v = (torch.as_tensor(x, dtype=torch.float64) for x in
                        (spot, strike, maturity, rate, div_yield, vol))
    forward = s * torch.exp((r - q) * t)
    df = torch.exp(-r * t)
    total_vol = v * torch.sqrt(t)
    d1 = (torch.log(forward / k) + 0.5 * total_vol**2) / total_vol
    d2 = d1 - total_vol
    call = df * (forward * _norm_cdf(d1) - k * _norm_cdf(d2))
    put = call - df * (forward - k)  # put-call parity
    call_intr = df * torch.clamp(forward - k, min=0.0)
    put_intr = df * torch.clamp(k - forward, min=0.0)
    return AnalyticPrices(
        put=put,
        call=call,
        put_intrinsic=put_intr,
        call_intrinsic=call_intr,
        put_convexity=put - put_intr,
        call_convexity=call - call_intr,
    )
