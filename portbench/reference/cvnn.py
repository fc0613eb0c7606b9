"""The complex-valued network, its loss and optax's Adam, in plain PyTorch.

Complex values travel as ``(re, im)`` pairs. A linear layer is ``(A + iB)(x +
iy) + b`` with the weights ``[in, out]``; modReLU scales by ``relu(|z| +
b)/(|z| + 1e-9)``; zReLU passes ``z`` where both parts are at least 0; the
covariance batch norm (Trabelsi et al. 2018) whitens each feature by the
inverse square root of its 2x2 covariance (batch statistics in training,
the running ones in evaluation; eps 1e-5 on the diagonal) and applies
``Γ = [[g_rr, g_ri], [g_ri, g_ii]]`` and ``β``. A residual block adds its
input (through a bias-free projection where the width changes) and applies
its activation. The output head is a linear layer to ``network_size``.

Weights are keyed by path as the program names them, ``layer_<i>`` for the
i-th layer of a sequence (an activated linear layer is a sequence of the
layer and its activation), ``body``, ``projection`` and
``post_activation`` inside a residual block. Everything is computed in the
dtype of the weights handed in.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

MODRELU_EPS = 1e-9
BN_EPS = 1e-5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

Pair = tuple[torch.Tensor, torch.Tensor]


class Network:
    """A forward function over a flat weight map, built from the layer list."""

    def __init__(self, layers: list[dict[str, Any]], input_dim: int, output_dim: int) -> None:
        self.linear_shapes: dict[str, tuple[int, int, bool]] = {}
        self.modrelu: dict[str, int] = {}
        self.cov_bn: dict[str, int] = {}
        fns: list[Callable[..., Pair]] = []
        dim = input_dim
        for i, layer in enumerate(layers):
            fn, dim = self._compile(layer, dim, f"layer_{i}")
            fns.append(fn)
        fns.append(self._linear(f"layer_{len(layers)}", dim, output_dim, True))
        self._fns = fns

    def _linear(self, path: str, n_in: int, n_out: int, bias: bool) -> Callable[..., Pair]:
        self.linear_shapes[path] = (n_in, n_out, bias)

        def fn(w: dict[str, torch.Tensor], s: dict, re: torch.Tensor, im: torch.Tensor,
               train: bool) -> Pair:
            a, b = w[f"{path}/w_re"], w[f"{path}/w_im"]
            out_re, out_im = re @ a - im @ b, re @ b + im @ a
            if bias:
                out_re, out_im = out_re + w[f"{path}/b_re"], out_im + w[f"{path}/b_im"]
            return out_re, out_im

        return fn

    def _activation(self, kind: str, path: str, width: int) -> Callable[..., Pair]:
        if kind == "zrelu":
            def zrelu(w: dict, s: dict, re: torch.Tensor, im: torch.Tensor, train: bool) -> Pair:
                keep = ((re >= 0) & (im >= 0)).to(re.dtype)
                return re * keep, im * keep
            return zrelu
        self.modrelu[path] = width

        def modrelu(w: dict, s: dict, re: torch.Tensor, im: torch.Tensor, train: bool) -> Pair:
            mag = torch.sqrt(re * re + im * im)
            scale = torch.relu(mag + w[f"{path}/b"]) / (mag + MODRELU_EPS)
            return re * scale, im * scale

        return modrelu

    def _compile(self, layer: dict[str, Any], dim: int, path: str) -> tuple[Callable[..., Pair], int]:
        kind = layer["kind"]
        if kind == "linear":
            out = layer.get("width") or dim
            act = layer.get("activation", "none")
            if act == "none":
                return self._linear(path, dim, out, layer.get("bias", True)), out
            return self._sequence([self._linear(f"{path}/layer_0", dim, out, layer.get("bias", True)),
                                   self._activation(act, f"{path}/layer_1", out)]), out
        if kind == "cov_bn":
            self.cov_bn[path] = dim
            return self._covariance_bn(path), dim
        if kind == "sequential":
            fns = []
            for j, sub in enumerate(layer["layers"]):
                fn, dim = self._compile(sub, dim, f"{path}/layer_{j}")
                fns.append(fn)
            return self._sequence(fns), dim
        if kind == "residual":
            body, out = self._compile(layer["body"], dim, f"{path}/body")
            proj = self._linear(f"{path}/projection", dim, out, False) if out != dim else None
            act = layer.get("activation", "none")
            post = None if act == "none" else self._activation(act, f"{path}/post_activation", out)

            def residual(w: dict, s: dict, re: torch.Tensor, im: torch.Tensor, train: bool) -> Pair:
                out_re, out_im = body(w, s, re, im, train)
                skip_re, skip_im = (re, im) if proj is None else proj(w, s, re, im, train)
                out_re, out_im = out_re + skip_re, out_im + skip_im
                return (out_re, out_im) if post is None else post(w, s, out_re, out_im, train)

            return residual, out
        raise ValueError(f"layer kind {kind!r} is not described by the reference")

    @staticmethod
    def _sequence(fns: list[Callable[..., Pair]]) -> Callable[..., Pair]:
        def sequence(w: dict, s: dict, re: torch.Tensor, im: torch.Tensor, train: bool) -> Pair:
            for fn in fns:
                re, im = fn(w, s, re, im, train)
            return re, im
        return sequence

    @staticmethod
    def _covariance_bn(path: str) -> Callable[..., Pair]:
        def bn(w: dict, s: dict, re: torch.Tensor, im: torch.Tensor, train: bool) -> Pair:
            if train:
                cre, cim = re - torch.mean(re, dim=0), im - torch.mean(im, dim=0)
                v_rr = torch.mean(cre * cre, dim=0)
                v_ri = torch.mean(cre * cim, dim=0)
                v_ii = torch.mean(cim * cim, dim=0)
            else:
                cre, cim = re - s[f"{path}/mean_re"], im - s[f"{path}/mean_im"]
                v_rr, v_ri, v_ii = s[f"{path}/c_rr"], s[f"{path}/c_ri"], s[f"{path}/c_ii"]
            v_rr, v_ii = v_rr + BN_EPS, v_ii + BN_EPS
            root_det = torch.sqrt(v_rr * v_ii - v_ri * v_ri)
            inv = 1.0 / (root_det * torch.sqrt(v_rr + v_ii + 2.0 * root_det))
            # the inverse square root of [[v_rr, v_ri], [v_ri, v_ii]]
            i_rr, i_ri, i_ii = (v_ii + root_det) * inv, -v_ri * inv, (v_rr + root_det) * inv
            white_re = i_rr * cre + i_ri * cim
            white_im = i_ri * cre + i_ii * cim
            g_rr, g_ri, g_ii = w[f"{path}/g_rr"], w[f"{path}/g_ri"], w[f"{path}/g_ii"]
            return (g_rr * white_re + g_ri * white_im + w[f"{path}/beta_re"],
                    g_ri * white_re + g_ii * white_im + w[f"{path}/beta_im"])
        return bn

    def __call__(self, weights: dict[str, torch.Tensor], state: dict[str, torch.Tensor],
                 re: torch.Tensor, im: torch.Tensor, *, train: bool) -> Pair:
        for fn in self._fns:
            re, im = fn(weights, state, re, im, train)
        return re, im


def spectrum_loss(net: Network, weights: dict[str, torch.Tensor], state: dict[str, torch.Tensor],
                  inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``mean((Re f − Re t)²) + mean((Im f − Im t)²)`` in training mode."""
    out_re, out_im = net(weights, state, inputs, torch.zeros_like(inputs), train=True)
    t_re, t_im = targets.real.to(inputs.dtype), targets.imag.to(inputs.dtype)
    return torch.mean(torch.square(out_re - t_re)) + torch.mean(torch.square(out_im - t_im))


def adam_step(weights: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
              mu: dict[str, torch.Tensor], nu: dict[str, torch.Tensor], count: int,
              learning_rate: float) -> int:
    """optax's Adam in place: moments, bias corrections of the new count,
    ``p − lr·m̂/(sqrt(v̂) + eps)``; returns the new count."""
    count += 1
    bc1, bc2 = 1.0 - ADAM_B1**count, 1.0 - ADAM_B2**count
    with torch.no_grad():
        for key, p in weights.items():
            g = grads[key]
            mu[key] = (1.0 - ADAM_B1) * g + ADAM_B1 * mu[key]
            nu[key] = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu[key]
            p -= learning_rate * ((mu[key] / bc1) / (torch.sqrt(nu[key] / bc2) + ADAM_EPS))
    return count
