"""Observability: console + JSONL metric logging, device memory, profiling.

Counterpart of ``tair_tpu/utils/logging.py``: a dependency-free JSONL metric
stream per experiment, process-0 gating when ``torch.distributed`` runs,
``TRACE_HBM=1`` device-memory reporting, and a context manager around
``torch.profiler`` for traces.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


def is_main_process() -> bool:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank() == 0
    return True


class MetricLogger:
    """JSONL + console metric stream, with an optional mirror:
    log_tool="tensorboard" (torch's SummaryWriter, imported when asked for)
    or "wandb" (external credentials; fails loudly if absent)."""

    def __init__(
        self,
        exp_dir: str,
        filename: str = "metrics.jsonl",
        log_tool: Optional[str] = None,
    ):
        self.exp_dir = exp_dir
        self.path = os.path.join(exp_dir, filename)
        self._tb = None
        if is_main_process():
            os.makedirs(exp_dir, exist_ok=True)
            if log_tool == "tensorboard":
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(exp_dir, "tb"))
            elif log_tool == "wandb":
                import wandb  # not bundled; needs external credentials

                wandb.init(project="tair-tpu", dir=exp_dir)
                self._tb = wandb
            elif log_tool not in (None, "", "jsonl"):
                raise ValueError(f"unknown log_tool {log_tool!r}")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict, prefix: str = "") -> None:
        if not is_main_process():
            return
        record = {
            "step": int(step),
            "time": round(time.time() - self._t0, 2),
            **{
                (f"{prefix}{k}"): (float(v) if hasattr(v, "__float__") else v)
                for k, v in metrics.items()
            },
        }
        if os.environ.get("TRACE_HBM") == "1":
            record["hbm"] = hbm_usage_mb()
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            scalars = {
                k: v for k, v in record.items()
                if isinstance(v, float) and k not in ("time",)
            }
            if hasattr(self._tb, "add_scalar"):  # tensorboard
                for k, v in scalars.items():
                    self._tb.add_scalar(k, v, int(step))
            else:  # wandb
                self._tb.log(scalars, step=int(step))
        items = ", ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record.items()
            if k not in ("time",)
        )
        print(f"[{record['time']:9.1f}s] {items}", flush=True)


def hbm_usage_mb() -> Optional[float]:
    """Device memory held by tensors (MiB), or None without a CUDA device."""
    if not torch.cuda.is_available():
        return None
    return round(torch.cuda.memory_allocated() / 2**20, 1)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """torch.profiler trace of the block, written for tensorboard into `log_dir`."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
