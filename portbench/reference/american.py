"""Monte-Carlo spectrum targets of flat-GBM American (Bermudan) puts by
Longstaff–Schwartz, in plain PyTorch.

Paths: as ``reference/gbm.py``'s stream, with one draw a step and the
single-step shock ``z = r·cos 2πu2``; with a monitor date every step the
price row of date ``d`` is ``exp(ln S)`` after step ``d``. Backward
induction over dates ``N−1 .. 1``: the cashflow carried from the next date
is discounted one step (``e^{−r·dt}``); among the paths in the money, the
continuation value is regressed on the powers ``x^0 .. x^d`` of ``x =
5·(S/K − 1)`` (moments over all paths, normalized by their count; a ridge of
``1e-6·G_jj`` on the diagonal; an all-zero system gives ``β = 0``), and a
path exercises where its exercise value passes its fitted continuation. The
cashflow at the first date, discounted one more step to time 0, is the
payoff; the target is the FFT of its row mean laid out as ``[rows, cols]``
(no forward normalization).
"""

from __future__ import annotations

import math

import torch

from portbench.reference.philox import MASK32, contract_keys, philox4x32

RIDGE = 1e-6


def monitor_rows(params: torch.Tensor, draws: torch.Tensor, *, mc_seed: int, rows: int,
                 cols: int, steps: int, dtype: torch.dtype) -> torch.Tensor:
    """``[C, steps, rows·cols]`` prices at every step."""
    device = params.device
    k0, k1 = (k[:, None] for k in contract_keys(mc_seed, draws))
    path = torch.arange(rows * cols, dtype=torch.int64, device=device)[None, :]
    c0, c1 = path & MASK32, path >> 32
    zero = torch.zeros_like(c0)
    p = params.to(dtype)
    spot, maturity, rate, div, vol = (p[:, i, None] for i in (0, 2, 3, 4, 5))
    dt = maturity / steps
    drift = (rate - div - 0.5 * vol * vol) * dt
    vol_sdt = vol * torch.sqrt(dt)
    log_s = torch.log(spot).expand(p.shape[0], rows * cols)
    out = torch.empty((p.shape[0], steps, rows * cols), dtype=dtype, device=device)
    for j in range(steps):
        if j % 2 == 0:
            words = philox4x32((c0, c1, zero + j // 2, zero), (k0, k1))
        h = j % 2
        u1 = (words[2 * h] >> 8).to(dtype) * 2.0**-24 + 2.0**-25
        u2 = (words[2 * h + 1] >> 8).to(dtype) * 2.0**-24
        shock = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
        log_s = log_s + drift + vol_sdt * shock
        out[:, j] = torch.exp(log_s)
    return out


def _solve(gram: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``β`` of ``(G + ridge) β = rhs`` per contract by Cholesky, one rounding
    an operation in the moments' dtype, as the estimator defines it: the
    ridge ``1e-6·max(G_jj, 1e-30)``; a pivot under ``8e-6·a_jj`` drops its
    column (``β_j = 0``); a pivot's root at least ``max(1e-6·a_jj, 1e-30)``."""
    k = rhs.shape[-1]
    a = gram.clone()
    idx = torch.arange(k, device=a.device)
    a[:, idx, idx] = a[:, idx, idx] + RIDGE * torch.clamp(a[:, idx, idx], min=1e-30)
    low = torch.zeros_like(a)
    keep = torch.ones_like(rhs)
    for j in range(k):
        d = a[:, j, j] - torch.sum(low[:, j, :j] * low[:, j, :j], dim=-1)
        keep[:, j] = (d >= 8.0 * RIDGE * a[:, j, j]).to(a.dtype)
        low[:, j, j] = torch.sqrt(torch.clamp(torch.maximum(d, RIDGE * a[:, j, j]), min=1e-30))
        for i in range(j + 1, k):
            s = a[:, i, j] - torch.sum(low[:, i, :j] * low[:, j, :j], dim=-1)
            low[:, i, j] = keep[:, j] * (s / low[:, j, j])
    z = torch.zeros_like(rhs)
    for i in range(k):
        z[:, i] = keep[:, i] * ((rhs[:, i] - torch.sum(low[:, i, :i] * z[:, :i], dim=-1))
                                / low[:, i, i])
    beta = torch.zeros_like(rhs)
    for i in reversed(range(k)):
        beta[:, i] = keep[:, i] * ((z[:, i] - torch.sum(low[:, i + 1:, i] * beta[:, i + 1:], dim=-1))
                                   / low[:, i, i])
    return beta


def put_cashflows(prices: torch.Tensor, params: torch.Tensor, *, steps: int,
                  degree: int) -> torch.Tensor:
    """``[C, P]`` Longstaff–Schwartz cashflows of the put at time 0."""
    p = params.to(prices.dtype)
    strike = p[:, 1, None]
    disc = torch.exp(-p[:, 3] * p[:, 2] / steps)[:, None]
    cash = torch.clamp(strike - prices[:, -1], min=0.0)
    n = prices.shape[-1]
    for d in range(steps - 2, -1, -1):
        s = prices[:, d]
        now = torch.clamp(strike - s, min=0.0)
        itm = (now > 0).to(s.dtype)
        y = disc * cash
        x = 5.0 * (s / strike - 1.0)
        powers = [torch.ones_like(x)]
        for _ in range(2 * degree):
            powers.append(powers[-1] * x)
        moments = torch.stack([torch.sum((itm * q).double(), dim=1) for q in powers], dim=1) / n
        rhs = torch.stack([torch.sum((itm * y * q).double(), dim=1)
                           for q in powers[:degree + 1]], dim=1) / n
        index = torch.arange(degree + 1, device=s.device)
        gram = moments[:, index[:, None] + index[None, :]]
        beta = _solve(gram.to(s.dtype), rhs.to(s.dtype))
        fitted = sum(beta[:, j, None] * powers[j] for j in range(degree + 1))
        cash = torch.where((itm > 0) & (now > fitted), now, y)
    return disc * cash


def american_put_spectra(params: torch.Tensor, draws: torch.Tensor, *, mc_seed: int, rows: int,
                         cols: int, steps: int, degree: int, dtype: torch.dtype = torch.float32,
                         block: int = 8) -> torch.Tensor:
    """``[C, cols]`` complex64 targets of ``params [C, 6]`` at ``draws [C]``."""
    out = []
    for lo in range(0, params.shape[0], block):
        prm, drw = params[lo:lo + block], draws[lo:lo + block]
        prices = monitor_rows(prm, drw, mc_seed=mc_seed, rows=rows, cols=cols, steps=steps,
                              dtype=dtype)
        cash = put_cashflows(prices, prm, steps=steps, degree=degree)
        row_mean = torch.mean(cash.reshape(prm.shape[0], rows, cols).float(), dim=1)
        out.append(torch.fft.fft(row_mean, dim=-1))
    return torch.cat(out)
