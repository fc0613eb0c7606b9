"""Complex-valued neural-network layers as ``nn.Module``s.

The port of the JAX package's ``models/cvnn.py``. Complex values stay split
into real ``(re, im)`` tensors, as there, so the four real matmuls of
ComplexLinear map onto plain float32 GEMMs and Adam on the real leaves is the
same update. Parameter and buffer names are the JAX leaf names, and
containers name their children ``layer_{i}`` / ``body`` / ``projection`` /
``post_activation``, so ``named_parameters()`` spells the JAX flat keys
(``models/factory.py`` maps them).

Differences from the JAX layers, both PyTorch idiom:

* ``train``/``eval`` mode (``self.training``) replaces the ``train`` flag;
* batch-norm running statistics are buffers updated in place during a
  training forward, where the JAX layers return a new state tree.

Each module can also fill its parameters from a threefry key
(``init_from_key``), reproducing the JAX ``init`` bit for bit.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from spectralmc_tpu_torch.ops import rng

MODRELU_EPS = 1e-9
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class ComplexModule(nn.Module):
    """Protocol: ``forward(re, im) -> (re, im)`` and ``init_from_key(key)``."""

    def init_from_key(self, key: torch.Tensor) -> None:
        """Layers without random init keep their constant initial values."""
        del key


class ComplexLinear(ComplexModule):
    """Dense C^in -> C^out as four real matmuls; weights stored ``[in, out]``.

    The JAX layout (``x @ W``) is kept, not ``nn.Linear``'s ``[out, in]``, so
    checkpoints carry over without transposes.
    """

    def __init__(
        self, in_dim: int, out_dim: int, *, bias: bool = True, dtype: torch.dtype = torch.float32
    ) -> None:
        super().__init__()
        self.in_dim, self.out_dim, self.bias = in_dim, out_dim, bias
        self.w_re = nn.Parameter(torch.zeros((in_dim, out_dim), dtype=dtype))
        self.w_im = nn.Parameter(torch.zeros((in_dim, out_dim), dtype=dtype))
        if bias:
            self.b_re = nn.Parameter(torch.zeros((out_dim,), dtype=dtype))
            self.b_im = nn.Parameter(torch.zeros((out_dim,), dtype=dtype))

    @torch.no_grad()
    def init_from_key(self, key: torch.Tensor) -> None:
        """Glorot-uniform from ``split(key)``, the JAX init's exact draws in
        the layer's dtype (float32 or float64).

        The bound is ``sqrt(6 / (in + out))`` in float64 rounded once to the
        layer's dtype (the JAX package computes it in float64 when x64 is on,
        as its tests run).
        """
        k_re, k_im = rng.split(key.cpu(), 2)
        dtype = self.w_re.dtype
        bound = float(torch.tensor(math.sqrt(6.0 / (self.in_dim + self.out_dim)), dtype=dtype))
        shape = (self.in_dim, self.out_dim)
        self.w_re.copy_(rng.uniform(k_re, shape, -bound, bound, dtype=dtype))
        self.w_im.copy_(rng.uniform(k_im, shape, -bound, bound, dtype=dtype))
        if self.bias:
            self.b_re.zero_()
            self.b_im.zero_()

    def forward(self, re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        # (A + iB)(x + iy) = (Ax - By) + i(Bx + Ay)
        out_re = re @ self.w_re - im @ self.w_im
        out_im = re @ self.w_im + im @ self.w_re
        if self.bias:
            out_re = out_re + self.b_re
            out_im = out_im + self.b_im
        return out_re, out_im


class ZReLU(ComplexModule):
    """First-quadrant gate: pass iff Re >= 0 and Im >= 0 (Guberman 2016)."""

    def forward(self, re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        mask = torch.logical_and(re >= 0, im >= 0).to(re.dtype)
        return re * mask, im * mask


class ModReLU(ComplexModule):
    """Magnitude gate with learned per-feature bias, phase-preserving (Arjovsky 2016)."""

    def __init__(self, features: int, *, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.b = nn.Parameter(torch.zeros((features,), dtype=dtype))

    @torch.no_grad()
    def init_from_key(self, key: torch.Tensor) -> None:
        del key
        self.b.zero_()

    def forward(self, re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        mag = torch.sqrt(re * re + im * im)
        scale = torch.relu(mag + self.b) / (mag + MODRELU_EPS)
        return re * scale, im * scale


class NaiveComplexBatchNorm(ComplexModule):
    """Independent batch norm on Re and Im; running var tracked unbiased."""

    def __init__(
        self,
        features: int,
        *,
        dtype: torch.dtype = torch.float32,
        momentum: float = BN_MOMENTUM,
        eps: float = BN_EPS,
    ) -> None:
        super().__init__()
        self.momentum, self.eps = momentum, eps
        for part in ("re", "im"):
            self.register_parameter(f"gamma_{part}", nn.Parameter(torch.ones(features, dtype=dtype)))
            self.register_parameter(f"beta_{part}", nn.Parameter(torch.zeros(features, dtype=dtype)))
            self.register_buffer(f"mean_{part}", torch.zeros(features, dtype=dtype))
            self.register_buffer(f"var_{part}", torch.ones(features, dtype=dtype))

    @torch.no_grad()
    def init_from_key(self, key: torch.Tensor) -> None:
        del key
        for part in ("re", "im"):
            getattr(self, f"gamma_{part}").fill_(1.0)
            getattr(self, f"beta_{part}").zero_()
            getattr(self, f"mean_{part}").zero_()
            getattr(self, f"var_{part}").fill_(1.0)

    def _bn(self, x: torch.Tensor, part: str) -> torch.Tensor:
        gamma, beta = getattr(self, f"gamma_{part}"), getattr(self, f"beta_{part}")
        mean, var = getattr(self, f"mean_{part}"), getattr(self, f"var_{part}")
        if self.training:
            batch_mean = torch.mean(x, dim=0)
            batch_var = torch.var(x, dim=0, unbiased=False)
            n = x.shape[0]
            with torch.no_grad():
                m = self.momentum
                mean.copy_((1 - m) * mean + m * batch_mean)
                var.copy_((1 - m) * var + m * (batch_var * (n / max(n - 1, 1))))
            x_hat = (x - batch_mean) * torch.rsqrt(batch_var + self.eps)
        else:
            x_hat = (x - mean) * torch.rsqrt(var + self.eps)
        return gamma * x_hat + beta

    def forward(self, re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self._bn(re, "re"), self._bn(im, "im")


def inv_sqrt_2x2(
    c_rr: torch.Tensor, c_ri: torch.Tensor, c_ii: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form inverse square root of SPD [[c_rr, c_ri], [c_ri, c_ii]].

    With s = sqrt(det), t = sqrt(trace + 2 s):
    M^{-1/2} = [[c_ii + s, -c_ri], [-c_ri, c_rr + s]] / (s t).
    """
    c_rr = c_rr + eps
    c_ii = c_ii + eps
    det = c_rr * c_ii - c_ri * c_ri
    s = torch.sqrt(det)
    t = torch.sqrt(c_rr + c_ii + 2.0 * s)
    denom = 1.0 / (s * t)
    return (c_ii + s) * denom, -c_ri * denom, (c_rr + s) * denom


class CovarianceComplexBatchNorm(ComplexModule):
    """Trabelsi-2018 whitening batch norm with learnable Γ and complex shift β.

    Γ starts at (1/√2, 0, 1/√2), the running covariance at (0.5, 0, 0.5).
    """

    def __init__(
        self,
        features: int,
        *,
        dtype: torch.dtype = torch.float32,
        momentum: float = BN_MOMENTUM,
        eps: float = BN_EPS,
    ) -> None:
        super().__init__()
        self.momentum, self.eps = momentum, eps
        f = (features,)
        self.g_rr = nn.Parameter(torch.zeros(f, dtype=dtype))
        self.g_ri = nn.Parameter(torch.zeros(f, dtype=dtype))
        self.g_ii = nn.Parameter(torch.zeros(f, dtype=dtype))
        self.beta_re = nn.Parameter(torch.zeros(f, dtype=dtype))
        self.beta_im = nn.Parameter(torch.zeros(f, dtype=dtype))
        for name in ("mean_re", "mean_im", "c_rr", "c_ri", "c_ii"):
            self.register_buffer(name, torch.zeros(f, dtype=dtype))
        self.init_from_key(torch.zeros(2, dtype=torch.int64))

    @torch.no_grad()
    def init_from_key(self, key: torch.Tensor) -> None:
        del key
        inv_sqrt2 = float(torch.tensor(1.0 / math.sqrt(2.0), dtype=self.g_rr.dtype))
        self.g_rr.fill_(inv_sqrt2)
        self.g_ri.zero_()
        self.g_ii.fill_(inv_sqrt2)
        self.beta_re.zero_()
        self.beta_im.zero_()
        self.mean_re.zero_()
        self.mean_im.zero_()
        self.c_rr.fill_(0.5)
        self.c_ri.zero_()
        self.c_ii.fill_(0.5)

    def forward(self, re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if self.training:
            mean_re = torch.mean(re, dim=0)
            mean_im = torch.mean(im, dim=0)
            cre = re - mean_re
            cim = im - mean_im
            c_rr = torch.mean(cre * cre, dim=0)
            c_ri = torch.mean(cre * cim, dim=0)
            c_ii = torch.mean(cim * cim, dim=0)
            with torch.no_grad():
                m = self.momentum
                for name, batch in (("mean_re", mean_re), ("mean_im", mean_im),
                                    ("c_rr", c_rr), ("c_ri", c_ri), ("c_ii", c_ii)):
                    buf = getattr(self, name)
                    buf.copy_((1 - m) * buf + m * batch)
        else:
            cre = re - self.mean_re
            cim = im - self.mean_im
            c_rr, c_ri, c_ii = self.c_rr, self.c_ri, self.c_ii
        w_rr, w_ri, w_ii = inv_sqrt_2x2(c_rr, c_ri, c_ii, self.eps)
        white_re = w_rr * cre + w_ri * cim
        white_im = w_ri * cre + w_ii * cim
        out_re = self.g_rr * white_re + self.g_ri * white_im + self.beta_re
        out_im = self.g_ri * white_re + self.g_ii * white_im + self.beta_im
        return out_re, out_im


class ComplexSequential(ComplexModule):
    """Children ``layer_0 .. layer_{n-1}`` applied in order."""

    def __init__(self, layers: tuple[ComplexModule, ...]) -> None:
        super().__init__()
        self.n_layers = len(layers)
        for i, layer in enumerate(layers):
            self.add_module(f"layer_{i}", layer)

    def children_in_order(self) -> list[ComplexModule]:
        return [getattr(self, f"layer_{i}") for i in range(self.n_layers)]

    def init_from_key(self, key: torch.Tensor) -> None:
        keys = rng.split(key.cpu(), max(self.n_layers, 1))
        for i, layer in enumerate(self.children_in_order()):
            layer.init_from_key(keys[i])

    def forward(self, re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        for layer in self.children_in_order():
            re, im = layer(re, im)
        return re, im


class ComplexResidual(ComplexModule):
    """Residual wrapper with optional projection and post-activation."""

    def __init__(
        self,
        body: ComplexModule,
        projection: ComplexModule | None = None,
        post_activation: ComplexModule | None = None,
    ) -> None:
        super().__init__()
        self.body = body
        self.projection = projection
        self.post_activation = post_activation

    def init_from_key(self, key: torch.Tensor) -> None:
        k_body, k_proj, k_act = rng.split(key.cpu(), 3)
        self.body.init_from_key(k_body)
        if self.projection is not None:
            self.projection.init_from_key(k_proj)
        if self.post_activation is not None:
            self.post_activation.init_from_key(k_act)

    def forward(self, re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        out_re, out_im = self.body(re, im)
        if self.projection is not None:
            skip_re, skip_im = self.projection(re, im)
        else:
            skip_re, skip_im = re, im
        out_re = out_re + skip_re
        out_im = out_im + skip_im
        if self.post_activation is not None:
            out_re, out_im = self.post_activation(out_re, out_im)
        return out_re, out_im
