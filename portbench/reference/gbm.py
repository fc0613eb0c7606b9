"""Monte-Carlo spectrum targets of flat-GBM TERMINAL puts, in plain PyTorch.

For contract ``(spot, strike, maturity, rate, div_yield, vol)`` and draw
index ``n``: the Philox key is ``fold_in(PRNGKey(mc_seed), n)``; path ``p =
row·cols + col`` reads call ``i`` of its stream at counter ``(p mod 2^32, p
>> 32, i, 0)``; draw ``j`` takes words ``2(j mod 2)`` and ``2(j mod 2) + 1``
of call ``j // 2`` as ``u1 = (w >> 8)·2^-24 + 2^-25`` and ``u2 = (w >>
8)·2^-24``; Box–Muller gives ``z1 = r·cos 2πu2`` and ``z2 = r·sin 2πu2``
with ``r = sqrt(−2 ln u1)``. Log-Euler moves two steps on a draw, ``ln S +=
2·(r − q − σ²/2)·dt + σ·sqrt(dt)·(z1 + z2)``, and an odd last step on ``z1``.
With MEAN normalization each contract's terminal values are rescaled so
that their sample mean is the forward ``S·e^{(r−q)T}``; the target is the
FFT of the row mean of the discounted put ``e^{−rT}·max(K − S_T, 0)`` laid
out as ``[rows, cols]``.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.philox import MASK32, contract_keys, philox4x32


def terminal_spectra(params: torch.Tensor, draws: torch.Tensor, *, mc_seed: int, rows: int,
                     cols: int, steps: int, normalize: bool, dtype: torch.dtype = torch.float32,
                     block: int = 16) -> torch.Tensor:
    """``[C, cols]`` complex64 targets of ``params [C, 6]`` at ``draws [C]``,
    the arithmetic in ``dtype``, ``block`` contracts at a time."""
    out = []
    for lo in range(0, params.shape[0], block):
        out.append(_block(params[lo:lo + block], draws[lo:lo + block], mc_seed=mc_seed,
                          rows=rows, cols=cols, steps=steps, normalize=normalize, dtype=dtype))
    return torch.cat(out)


def _block(params: torch.Tensor, draws: torch.Tensor, *, mc_seed: int, rows: int, cols: int,
           steps: int, normalize: bool, dtype: torch.dtype) -> torch.Tensor:
    device = params.device
    k0, k1 = (k[:, None, None] for k in contract_keys(mc_seed, draws))
    path = torch.arange(rows * cols, dtype=torch.int64, device=device).reshape(1, rows, cols)
    c0, c1 = path & MASK32, path >> 32
    zero = torch.zeros_like(c0)
    p = params.to(dtype)
    spot, strike, maturity, rate, div, vol = (p[:, i, None, None] for i in range(6))
    dt = maturity / steps
    drift = (rate - div - 0.5 * vol * vol) * dt
    vol_sdt = vol * torch.sqrt(dt)
    pairs, draw_count = steps // 2, steps // 2 + steps % 2
    log_s = torch.log(spot).expand(p.shape[0], rows, cols)
    for call in range(-(-draw_count // 2)):
        words = philox4x32((c0, c1, zero + call, zero), (k0, k1))
        for half in range(2):
            j = 2 * call + half
            if j >= draw_count:
                break
            u1 = (words[2 * half] >> 8).to(dtype) * 2.0**-24 + 2.0**-25
            u2 = (words[2 * half + 1] >> 8).to(dtype) * 2.0**-24
            radius = torch.sqrt(-2.0 * torch.log(u1))
            angle = (2.0 * math.pi) * u2
            if j < pairs:
                shock = radius * torch.cos(angle) + radius * torch.sin(angle)
                log_s = log_s + 2.0 * drift + vol_sdt * shock
            else:
                log_s = log_s + drift + vol_sdt * (radius * torch.cos(angle))
    terminal = torch.exp(log_s).reshape(p.shape[0], rows * cols)
    if normalize:
        forward = (spot * torch.exp((rate - div) * maturity)).reshape(-1, 1)
        terminal = terminal * (forward / torch.mean(terminal, dim=1, keepdim=True))
    df = torch.exp(-rate * maturity).reshape(-1, 1)
    put = df * torch.clamp(strike.reshape(-1, 1) - terminal, min=0.0)
    row_mean = torch.mean(put.reshape(p.shape[0], rows, cols), dim=1)
    return torch.fft.fft(row_mean.to(torch.float32), dim=-1)
