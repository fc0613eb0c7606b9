"""Operations and bytes of the port's path and LSMC kernels at a launched shape.

Frozen copies of ``chip_smoke.py``'s ``bound_ms`` (its flat-GBM branches),
``american_bound_ms`` and ``lsmc_bound_ms`` as they stood when this benchmark
was written, so that the yardstick does not move when a later change edits
the program or its smoke script. The counts follow the work that the
algorithm and its inputs need, never a kernel's SASS:

* per path: the Philox round keys (9 rounds' two key additions: 18), a
  function of the contract's key only;
* per two-word draw: half a Philox call (10 rounds of 2 mul-hi, 2 mul-lo and
  4 xor: 80 operations a call), the two uniforms (shift, convert, fma each),
  log, mul, sqrt and the sine or cosine with its argument: 50;
* per path-step of a branch: the state update and the branch's own work
  (``UNIT_OPS``);
* bytes: each contract's parameters and key read once and each output float
  written once.

A bound is the larger of operations over the float32 rate outside the tensor
cores and bytes over HBM bandwidth (NVIDIA H100 SXM data sheet: 67 TFLOP/s,
3.35 TB/s), with integer and transcendental operations counted one each at
that rate. Every function returns ``(milliseconds, "operations" | "bytes")``.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
PHILOX_KEY_OPS = 18
DRAW_OPS = 50
UNIT_OPS = {"terminal": 3, "barrier": 4, "lookback": 4, "variance": 4, "asian": 5}
PAIRED = ("terminal", "variance")  # two log-Euler steps from one draw
CONTRACT_FIELDS = 6  # spot, strike, maturity, rate, div_yield, vol
LSMC_DEGREE = 5


def _bound(ops: float, byte_count: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / FP32_OPS_PER_S * 1e3, byte_count / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gbm_paths_bound_ms(branch: str, contracts: int, rows: int, cols: int,
                       steps: int) -> tuple[float, str]:
    """Kernel #1 (``gbm_paths_kernel``), one launch of a flat GBM branch over
    ``contracts x rows x cols`` paths and ``steps`` log-Euler steps."""
    paths = contracts * rows * cols
    draws = -(-steps // 2) if branch in PAIRED else steps
    ops = paths * (PHILOX_KEY_OPS + draws * DRAW_OPS + steps * UNIT_OPS[branch])
    byte_count = contracts * (4 * CONTRACT_FIELDS + 8) + paths * 4
    return _bound(ops, byte_count)


def american_gbm_bound_ms(contracts: int, rows: int, cols: int, steps: int,
                          every: int = 1) -> tuple[float, str]:
    """Kernel #4 (``american_gbm_kernel``): the monitor rows, one exp a date;
    the contract and key in, one float a path and date out."""
    paths = contracts * rows * cols
    monitors = steps // every
    draws = monitors * (every // 2 + every % 2)
    ops = paths * (PHILOX_KEY_OPS + draws * DRAW_OPS + steps * UNIT_OPS["terminal"] + monitors)
    byte_count = contracts * 32 + paths * monitors * 4
    return _bound(ops, byte_count)


def lsmc_backward_bound_ms(contracts: int, rows: int, cols: int, monitors: int,
                           degree: int = LSMC_DEGREE) -> tuple[float, str]:
    """Kernel #11 (``backward_kernel``, one state), from the JAX kernel's own
    cost model: ``monitors + 1`` slabs of 4 bytes a path, and ``5(2d + 1) +
    2d + 8`` operations a path and date."""
    paths = contracts * rows * cols
    per_date = 5 * (2 * degree + 1) + 2 * degree + 8
    return _bound(per_date * paths * monitors, (monitors + 1) * paths * 4)
