"""Threefry-2x32 key streams in torch integer ops, word-exact with ``jax.random``.

The JAX package's stateless streams (``ops/rng.py`` there) address every
random number by a key derived from ``(seed, counter, ...)``. This module
reproduces the words of ``jax.random`` with ``jax_threefry_partitionable``
on (the JAX default), so that

* the canonical ``"xla"`` MC engine (``ops/gbm.py::simulate_terminal_rows``)
  draws the same normals as the JAX package, up to the ``erf_inv`` lowering;
* the ``"cuda"`` engine keys its Philox stream with the same per-contract
  key words the JAX kernel engine used (``fold_in(key(mc_seed), draw)``);
* ``create()`` reproduces the JAX CVNN initial weights bit for bit.

Representation: a key is an ``int64`` tensor ``[..., 2]`` of uint32 words
(uint32 has too few torch ops, so words ride in int64 and are masked to 32
bits after each add). All functions are plain tensor code and run on any
device. There is no hidden global generator: every draw names its key.
"""

from __future__ import annotations

import math

import torch
from pydantic import BaseModel, ConfigDict

from spectralmc_tpu_torch.core.errors.rng import (
    InvalidCounter,
    InvalidShape,
    RngError,
    SeedOutOfRange,
)
from spectralmc_tpu_torch.core.precision import Precision
from spectralmc_tpu_torch.core.result import Failure, Result, Success

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 (20 rounds) block function on broadcast uint32 words."""
    ks = (k1, k2, (k1 ^ k2 ^ _PARITY) & MASK32)
    a = (x1 + ks[0]) & MASK32
    b = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return a, b


def prng_key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` words: ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor | int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter pair ``(0, data)``.

    ``key`` is ``[..., 2]``; ``data`` broadcasts against ``key[..., 0]``, so
    one call folds a whole vector of counters into one key (or one counter
    into many keys).
    """
    data_t = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data_t), data_t)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for a single key ``[2]`` -> ``[num, 2]``.

    Under the partitionable layout the i-th subkey is threefry of ``(0, i)``,
    which is exactly ``fold_in(key, i)``.
    """
    return fold_in(key, torch.arange(num, dtype=torch.int64, device=key.device))


def _words(key: torch.Tensor, shape: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """Both uint32 outputs (as int64) of threefry over the 64-bit counters
    ``0 .. prod(shape) − 1`` (row-major), each split as ``(n >> 32, n &
    MASK)``; ``key`` may carry leading batch dims ``[*B, 2]``."""
    count = math.prod(shape)
    n = torch.arange(count, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    return threefry2x32(k1, k2, n >> 32, n & MASK32)


def bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` uint32 words (as int64).

    ``key`` may carry leading batch dims ``[*B, 2]``; the result is
    ``[*B, *shape]``. Word ``n`` (row-major flat index) is ``hi ^ lo`` of
    threefry over the 64-bit counter ``n`` split as ``(n >> 32, n & MASK)``.
    """
    a, b = _words(key, shape)
    return a ^ b


def _float32_from_words(words: torch.Tensor) -> torch.Tensor:
    """``[1, 2)`` float32 from the top 23 bits of uint32 words, minus one."""
    mant = ((words >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def fma32(a: torch.Tensor, b: torch.Tensor | float, c: torch.Tensor | float) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once, as XLA's CPU backend contracts it.

    The product of two float32 values is exact in float64, so the float64
    sum rounded to float32 is the fused result (short of a double-rounding
    tie, which the tests have not met).
    """
    return (a.double() * b + c).float()


def fma32_exact(a: torch.Tensor, b: torch.Tensor | float, c: torch.Tensor | float) -> torch.Tensor:
    """float32 ``a·b + c`` rounded exactly once, as ``__fmaf_rn`` rounds it.

    The product of two float32 values is exact in float64, so the float64
    sum ``s`` has one rounding, and its cast to float32 a second one. The two
    can differ from one rounding only where ``s`` lands exactly on a float32
    tie (the float64 rounding moved the sum onto the midpoint), where ``fma32``
    may miss by one ulp. There — and below float32's normal range, where
    the midpoints lie elsewhere in the bits — the sum is rounded to odd
    instead (Knuth's two-sum gives its error; an inexact sum with an even
    last bit moves one ulp toward the error), which the cast then rounds
    correctly. An exact zero sum (``p = −c``) is the FMA's zero, sign
    included, and needs neither. ``b`` and ``c`` must be float32 values."""
    p = a.double() * b
    s = p + c
    out = s.float()
    suspect = (((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000)
               | ((s.abs() < 2.0**-125) & (s != 0.0)))
    if bool(suspect.any()):
        s_t = s[suspect]
        p_t = p.expand(s.shape)[suspect]
        c_t = torch.as_tensor(c, dtype=torch.float64, device=s.device).expand(s.shape)[suspect]
        bp = s_t - p_t
        err = (p_t - (s_t - bp)) + (c_t - bp)
        toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
        inexact_even = (err != 0) & ((s_t.view(torch.int64) & 1) == 0)
        out[suspect] = torch.where(inexact_even, torch.nextafter(s_t, toward), s_t).float()
    return out


# The Box–Muller transform of the fixed-rounding streams, op for op
# (csrc/heston_step.cuh's ln_pinned, sincos_2pi_pinned and box_muller_pinned:
# the Heston, Merton, curved-term GBM and cliquet kernels' draw). The
# header's constants: Q's coefficients (ln), S's and C's (the quarter turn's
# sine and cosine), highest first, and ln 2 and π/2 in two parts each
LN_Q = (0.0880836695, -0.143519357, 0.149101794, -0.165631115, 0.199621201, -0.250021279,
        0.333339572, -0.499999851)
SIN_S = (-0.00462198071, 0.0796870366, -0.645964026)
COS_C = (0.000906741712, -0.0208615288, 0.253669411, -1.23370051)
LN2_HI, LN2_LO = 0.693145752, 1.42860677e-06
HALF_PI_HI, HALF_PI_LO = 1.57079637, -4.37113883e-08


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def _horner(x: torch.Tensor, coefficients: tuple[float, ...]) -> torch.Tensor:
    acc = torch.full_like(x, _f32(coefficients[0]))
    for c in coefficients[1:]:
        acc = fma32_exact(acc, x, _f32(c))
    return acc


def ln_pinned(u1: torch.Tensor) -> torch.Tensor:
    """``csrc/heston_step.cuh::ln_pinned`` op for op: float32 ``ln u1`` for
    ``u1`` in ``[2^-25, 1]``, from the bits ``u1 = 2^k·z`` (``z`` in ``[√½,
    √2)``), ``f = z − 1``, ``f + f²·Q(f)`` and ``k·ln 2`` in two parts."""
    ix = u1.contiguous().view(torch.int32).to(torch.int64)
    k = (ix - 0x3F3504F3) >> 23
    f = (ix - (k << 23)).to(torch.int32).view(torch.float32) - 1.0
    kf = k.to(torch.float32)
    y = fma32_exact(f * f, _horner(f, LN_Q), f)
    return fma32_exact(kf, _f32(LN2_HI), fma32_exact(kf, _f32(LN2_LO), y))


def sincos_2pi_pinned(u2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``csrc/heston_step.cuh::sincos_2pi_pinned`` op for op: ``(cos 2πu2,
    sin 2πu2)`` float32 for ``u2 = m·2^-24``, from the nearest quarter turn
    ``q`` and the exact remainder ``r = 4u2 − q``."""
    m = (u2 * 2.0**24).to(torch.int64)
    q = (m + (1 << 21)) >> 22
    r = (m - (q << 22)).to(torch.float32) * 2.0**-22
    s = r * r
    sin_r = fma32_exact(r, _f32(HALF_PI_HI),
                        r * fma32_exact(s, _horner(s, SIN_S), _f32(HALF_PI_LO)))
    cos_r = fma32_exact(s, _horner(s, COS_C), 1.0)
    odd = (q & 1) == 1
    c, si = torch.where(odd, sin_r, cos_r), torch.where(odd, cos_r, sin_r)
    return (torch.where(((q + 1) & 2) != 0, -c, c), torch.where((q & 2) != 0, -si, si))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 ``√x`` correctly rounded, as ``__fsqrt_rn`` rounds it, on any
    device: the root in float64 rounded to float32 (a float64 root of a
    float32 value is never close enough to a float32 midpoint for the second
    rounding to miss). torch's own float32 root on the CPU can miss by an
    ulp."""
    return torch.sqrt(x.double()).float()


def box_muller_pinned(u1: torch.Tensor, u2: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``csrc/heston_step.cuh::box_muller_pinned``: ``(r, cos 2πu2, sin
    2πu2)`` of the draw's uniforms, bit for bit the kernel's."""
    return (sqrt_rn(-2.0 * ln_pinned(u1)), *sincos_2pi_pinned(u2))


def _two_product(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float64 ``a·b = p + e`` exactly (Dekker's split, no FMA needed)."""
    def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        t = x * 134217729.0  # 2^27 + 1
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma64(a: torch.Tensor, b: torch.Tensor | float, c: torch.Tensor | float) -> torch.Tensor:
    """float64 ``a·b + c`` rounded (almost always) once, as XLA's CPU
    backend contracts it: the exact product ``p + e``, then ``p + c`` with
    its rounding error by Knuth's two-sum, and the two tails added last.
    Double rounding can leave the last bit off in rare ties; the tests hold
    the normals to 1e-15 relative."""
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    c = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    p, e = _two_product(a, b)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    return s + (e + err)


def _float64_from_words(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``[1, 2)`` float64 from the top 52 bits of the 64-bit words ``hi << 32
    | lo`` (uint32 halves in int64), minus one. The logical shift ``>> 12``
    of the 64-bit word is ``hi << 20 | lo >> 12``: torch's ``>>`` on int64
    is arithmetic, so the halves are shifted apart."""
    mant = (hi << 20) | (lo >> 12) | 0x3FF0000000000000
    return mant.view(torch.float64) - 1.0


def uniform(
    key: torch.Tensor,
    shape: tuple[int, ...],
    minval: float = 0.0,
    maxval: float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``, bit-exact,
    for float32 (one 32-bit word a number, ``hi ^ lo``) and float64 (the
    64-bit word ``hi << 32 | lo`` of the same threefry call, as
    ``jax._src.prng._threefry_random_bits_partitionable`` builds it)."""
    if dtype == torch.float32:
        lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
        hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
        floats = _float32_from_words(bits(key, shape))
        return torch.maximum(lo, fma32(floats, float(hi - lo), float(lo)))
    if dtype != torch.float64:
        raise ValueError(f"uniform draws float32 or float64, not {dtype}")
    floats = _float64_from_words(*_words(key, shape))
    lo64 = torch.tensor(minval, dtype=torch.float64, device=key.device)
    span = float(torch.tensor(maxval, dtype=torch.float64) - float(minval))
    return torch.maximum(lo64, fma64(floats, span, lo64))


# float32 nextafter(-1, 0): the lower end of jax.random.normal's uniform
_NORMAL_LO = -0.99999994


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function with XLA's polynomial (Giles 2010).

    XLA lowers ``erf_inv`` for float32 to this two-branch polynomial; using
    the same coefficients keeps the port's normals within a few ulps of the
    JAX package's (the remaining difference is the ``log1p`` lowering).
    """
    w = -torch.log1p(-x * x)
    small = w < 5.0
    ws = w - 2.5
    wl = torch.sqrt(w) - 3.0
    ps = torch.full_like(x, 2.81022636e-08)
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
              -0.00125372503, -0.00417768164, 0.246640727, 1.50140941):
        ps = fma32(ps, ws.double(), float(torch.tensor(c, dtype=torch.float32)))
    pl = torch.full_like(x, -0.000200214257)
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682):
        pl = fma32(pl, wl.double(), float(torch.tensor(c, dtype=torch.float32)))
    p = torch.where(small, ps, pl)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


# XLA's float64 erf_inv (Giles 2010, double precision): the coefficients of
# its three branches, w < 6.25, w < 16 and w >= 16, highest degree first
_ERFINV64_CENTRAL = (
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.333171662854621e-16, 2.0972767875968562e-17,
    6.637638134358324e-15, -4.054566272975207e-14, -8.151934197605472e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11, -5.415412054294628e-11,
    1.0512122733215323e-09, -4.112633980346984e-09, -2.9070369957882005e-08,
    4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.006033670871430149,
    0.24015818242558962, 1.6536545626831027,
)
_ERFINV64_MIDDLE = (
    2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
    6.828485145957318e-05, 2.4031110387097894e-05, -0.0003550375203628475,
    0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851,
    -0.003751208507569241, 0.005370914553590064, 1.0052589676941592,
    3.0838856104922208,
)
_ERFINV64_TAIL = (
    -2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.914795345090108e-08, -6.771199775845234e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
    7.599527703001776e-05, -0.00021503011930044477, -0.00013871931833623122,
    1.0103004648645344, 4.849906401408584,
)


# XLA's CPU log1p (its elemental emitter, after Cephes): below |x| < √2 − 1
# the rational approximation x − x²/2 + x³·P(x)/Q(x), highest degree first
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log1p64(x: torch.Tensor) -> torch.Tensor:
    """float64 ``log1p`` as XLA's CPU backend lowers it (the rational
    branch's error reaches ~100 ulps near its threshold, so ``torch.log1p``
    would move the float64 normals there by up to 4e-15)."""
    def poly(coeffs: tuple[float, ...]) -> torch.Tensor:
        p = torch.zeros_like(x)
        for c in coeffs:
            p = fma64(p, x, c)
        return p

    x2 = x * x
    small = x + fma64(torch.full_like(x, -0.5), x2, (x * x2) * (poly(_LOG1P_P) / poly(_LOG1P_Q)))
    return torch.where(x.abs() < 0.41421356237309504880, small, torch.log(x + 1.0))


def erf_inv64(x: torch.Tensor) -> torch.Tensor:
    """float64 inverse error function in XLA's lowering of ``erf_inv``:
    ``w = −log1p(−x²)`` (``log1p64``), three Horner branches that start together and stop
    after 17 (w >= 16), 19 (w < 16) or 23 (w < 6.25) coefficients, each step
    a fused multiply-add."""
    w = -log1p64(-x * x)
    central = w < 6.25
    middle = w < 16.0
    t = torch.where(central, w - 3.125, torch.sqrt(w) - torch.where(middle, 3.25, 5.0))

    def coeff(i: int) -> torch.Tensor:
        c = torch.full_like(x, _ERFINV64_CENTRAL[i])
        if i < len(_ERFINV64_MIDDLE):
            c = torch.where(central, c, _ERFINV64_MIDDLE[i])
        if i < len(_ERFINV64_TAIL):
            c = torch.where(middle, c, _ERFINV64_TAIL[i])
        return c

    p = coeff(0)
    for i in range(1, len(_ERFINV64_CENTRAL)):
        step = fma64(p, t, coeff(i))
        if i >= len(_ERFINV64_MIDDLE):
            p = torch.where(central, step, p)
        elif i >= len(_ERFINV64_TAIL):
            p = torch.where(middle, step, p)
        else:
            p = step
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: tuple[int, ...],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: ``sqrt(2)·erf_inv(u)``, u
    uniform on ``[nextafter(−1, 0), 1)`` — float32 with the 32-bit words and
    XLA's float32 ``erf_inv``, float64 with the 64-bit words and its float64
    one."""
    if dtype == torch.float64:
        u = uniform(key, shape, math.nextafter(-1.0, 0.0), 1.0, dtype=torch.float64)
        return math.sqrt(2.0) * erf_inv64(u)
    if dtype != torch.float32:
        raise ValueError(f"normal draws float32 or float64, not {dtype}")
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return torch.tensor(math.sqrt(2.0), dtype=torch.float32, device=key.device) * erf_inv(u)

# --------------------------------------------------------------------------
# Normal-matrix streams: the JAX package's key-derivation convention
# --------------------------------------------------------------------------

_MAX_SEED = 2**63 - 1


class NormalStreamConfig(BaseModel):
    """Checkpointable description of a normal-matrix stream: the matrix for
    draw ``counter`` is ``normal(fold_in(prng_key(seed), counter))``."""

    model_config = ConfigDict(frozen=True, extra="forbid")

    rows: int
    cols: int
    seed: int
    counter: int = 0
    precision: Precision = Precision.float32


def build_normal_stream_config(
    *, rows: int, cols: int, seed: int, counter: int = 0, precision: Precision = Precision.float32
) -> Result[NormalStreamConfig, RngError]:
    if rows <= 0 or cols <= 0:
        return Failure(InvalidShape(rows=rows, cols=cols, reason="rows and cols must be positive"))
    if not (0 <= seed <= _MAX_SEED):
        return Failure(SeedOutOfRange(seed=seed, reason=f"seed must be in [0, {_MAX_SEED}]"))
    if counter < 0:
        return Failure(InvalidCounter(counter=counter, reason="counter must be non-negative"))
    return Success(
        NormalStreamConfig(rows=rows, cols=cols, seed=seed, counter=counter, precision=precision)
    )


def base_key(seed: int, device: torch.device | str) -> torch.Tensor:
    """The root threefry key for a seed, on ``device``."""
    return prng_key(seed, device)


def draw_key(key: torch.Tensor, counter: torch.Tensor | int) -> torch.Tensor:
    """The key for the ``counter``-th draw of a stream."""
    return fold_in(key, counter)


def normal_matrix(
    key: torch.Tensor, counter: torch.Tensor | int, rows: int, cols: int, dtype: torch.dtype
) -> torch.Tensor:
    """Standard-normal ``[rows, cols]`` matrix for draw index ``counter``, on
    the key's device; the same (seed, counter, shape, dtype) gives the same
    matrix on every device."""
    return normal(draw_key(key, counter), (rows, cols), dtype)


def stream_normals(cfg: NormalStreamConfig, device: torch.device | str) -> torch.Tensor:
    """Materialize the matrix for the stream's current counter on ``device``."""
    return normal_matrix(
        base_key(cfg.seed, device), cfg.counter, cfg.rows, cfg.cols, cfg.precision.to_torch()
    )


def advance(cfg: NormalStreamConfig, draws: int = 1) -> NormalStreamConfig:
    """Pure successor state after ``draws`` matrices have been consumed."""
    return cfg.model_copy(update={"counter": cfg.counter + draws})


# --------------------------------------------------------------------------
# Philox-4x32-10: the counter-based stream of the "cuda" MC engine
# --------------------------------------------------------------------------

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``m * x`` for uint32 ``x`` held in int64.

    The full product needs 64 unsigned bits, past int64, so the high word is
    assembled from two 16-bit halves of ``x`` (each partial product < 2^48).
    """
    lo = (x * m) & MASK32  # int64 wraps, the low 32 bits stay exact
    hi = ((x >> 16) * m + (((x & 0xFFFF) * m) >> 16)) >> 16
    return hi & MASK32, lo


def philox4x32(
    counter: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    key: tuple[torch.Tensor, torch.Tensor],
    rounds: int = 10,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Philox-4x32 (Salmon et al. 2011) on broadcast uint32 words (in int64).

    The same rounds and constants as ``csrc/gbm_paths.cu``; Random123's
    known-answer vectors pin both.
    """
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for i in range(rounds):
        if i:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3
