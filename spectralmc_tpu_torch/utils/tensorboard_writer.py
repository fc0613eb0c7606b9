"""TensorBoard logging: per-step and per-segment trainer metrics, and the
chain's history.

``TensorBoardLogger`` plugs into ``GbmCVNNPricer.set_step_callback`` (scalars
every step, histograms every ``hist_every``, a flush every ``flush_every``)
or, one call a segment, ``set_segment_callback`` (``log_segment``).
``log_chain_to_tensorboard`` writes a store's versions (their metadata, and
the checkpoint's ``global_step``, ``sobol_skip`` and parameter count), as the
storage CLI's ``tensorboard-log`` does.

The ``SummaryWriter`` import is gated, so the package works without the
tensorboard package.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import numpy as np

from spectralmc_tpu_torch.core.errors.storage import StorageError
from spectralmc_tpu_torch.core.result import Failure, Result, Success

if TYPE_CHECKING:  # pragma: no cover
    from spectralmc_tpu_torch.storage.store import AsyncBlockchainModelStore
    from spectralmc_tpu_torch.training.trainer import SegmentMetrics, StepMetrics


def _make_writer(logdir: str) -> "object":
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as exc:  # pragma: no cover — dependency gate
        raise ImportError("tensorboard logging requires the tensorboard package") from exc
    return SummaryWriter(log_dir=logdir)


class TensorBoardLogger:
    """Per-step metrics sink; plug into ``GbmCVNNPricer.set_step_callback``."""

    def __init__(
        self,
        logdir: str,
        *,
        hist_every: int = 50,
        flush_every: int = 100,
        param_source: "object | None" = None,
    ) -> None:
        self._writer = _make_writer(logdir)
        self._hist_every = hist_every
        self._flush_every = flush_every
        self._param_source = param_source  # callable () -> Mapping[str, array]

    def __call__(self, metrics: "StepMetrics") -> None:
        step = metrics.step
        self._writer.add_scalar("train/loss", metrics.loss, step)
        self._writer.add_scalar("train/grad_norm", metrics.grad_norm, step)
        self._writer.add_scalar("train/learning_rate", metrics.learning_rate, step)
        if self._param_source is not None and step % self._hist_every == 0:
            for name, value in self._param_source().items():
                self._writer.add_histogram(name, np.asarray(value), step)
        if step % self._flush_every == 0:
            self._writer.flush()

    def log_segment(self, metrics: "SegmentMetrics") -> None:
        """Bulk per-segment sink for ``GbmCVNNPricer.set_segment_callback``.

        One Python call per device scan: scalars for every step in the
        segment; histograms land on the exact ``hist_every`` multiples the
        segment crosses (same step grid as the per-step path) and flushes
        honor ``flush_every`` — never once-per-segment, which would defeat
        the seam under 1-batch commit intervals.
        """
        for i in range(len(metrics.losses)):
            step = metrics.start_step + i
            self._writer.add_scalar("train/loss", float(metrics.losses[i]), step)
            self._writer.add_scalar("train/grad_norm", float(metrics.grad_norms[i]), step)
            self._writer.add_scalar("train/learning_rate", metrics.learning_rate, step)
        last = metrics.start_step + len(metrics.losses) - 1
        if self._param_source is not None:
            first_mult = (metrics.start_step - 1) // self._hist_every + 1
            for mult in range(first_mult, last // self._hist_every + 1):
                step = mult * self._hist_every
                for name, value in self._param_source().items():
                    self._writer.add_histogram(name, np.asarray(value), step)
        if last // self._flush_every != (metrics.start_step - 1) // self._flush_every:
            self._writer.flush()

    def close(self) -> None:
        self._writer.flush()
        self._writer.close()


async def log_chain_to_tensorboard(
    store: "AsyncBlockchainModelStore", logdir: str
) -> Result[int, StorageError]:
    """Write the version chain's history into TensorBoard (CLI tensorboard-log)."""
    from spectralmc_tpu_torch.serialization import deserialize_checkpoint

    versions = await store.list_versions()
    if isinstance(versions, Failure):
        return Failure(versions.error)
    writer = _make_writer(logdir)
    count = 0
    for version in versions.value:
        writer.add_text(
            f"versions/{version.version_id}",
            f"semver={version.semantic_version} hash={version.content_hash[:12]} "
            f"msg={version.message} ts={version.timestamp}",
            version.counter,
        )
        payload = await store.load_checkpoint(version)
        if isinstance(payload, Failure):
            continue  # incomplete version: text-only entry
        restored = deserialize_checkpoint(payload.value)
        if isinstance(restored, Failure):
            continue
        cfg = restored.value
        writer.add_scalar("chain/global_step", cfg.global_step, version.counter)
        writer.add_scalar("chain/sobol_skip", cfg.sobol_skip, version.counter)
        if cfg.model_state:
            param_count = sum(math.prod(v.shape) for v in cfg.model_state.values())
            writer.add_scalar("chain/param_count", param_count, version.counter)
        count += 1
    # summary: versions a day over the chain's span
    if len(versions.value) >= 2:
        from datetime import datetime

        try:
            first = datetime.fromisoformat(versions.value[0].timestamp)
            last = datetime.fromisoformat(versions.value[-1].timestamp)
            span_days = max((last - first).total_seconds() / 86400.0, 1e-9)
            writer.add_scalar(
                "chain/versions_per_day", len(versions.value) / span_days, 0
            )
        except ValueError:
            pass  # non-ISO timestamps: skip the summary, never the log
    writer.flush()
    writer.close()
    return Success(count)
