"""Profiling and metrics (counterpart of raytrace_tpu/utils/profiling.py).

- ``trace(log_dir)``: context manager around ``torch.profiler`` that
  records the enclosed block (the host's operations, and the card's
  kernels where CUDA is available) and writes a Chrome trace into
  ``log_dir`` (open it in chrome://tracing or Perfetto).
- ``BatchMetrics``: per-batch counters (rays, seconds, Mrays/s, spp/s)
  with a JSONL sink, the JAX package's records and lines.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` and write its
    Chrome trace to ``log_dir``; yields the profiler, whose
    ``trace_path`` names the file once the block has ended.  A profiler
    that cannot start or write raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            # The block's kernels end inside the profiled window.
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
    log.info("profile written to %s", prof.trace_path)


@dataclass
class BatchRecord:
    batch: int
    seconds: float
    rays: float
    pixels: int
    spp: int

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds > 0 else 0.0

    @property
    def spp_per_sec(self) -> float:
        return self.spp / self.seconds if self.seconds > 0 else 0.0


@dataclass
class BatchMetrics:
    """Per-batch render metrics with optional JSONL persistence."""

    pixels: int
    spp: int
    jsonl_path: Optional[str] = None
    records: List[BatchRecord] = field(default_factory=list)

    def record(self, batch: int, seconds: float, rays: float) -> BatchRecord:
        rec = BatchRecord(batch=batch, seconds=seconds, rays=rays,
                          pixels=self.pixels, spp=self.spp)
        self.records.append(rec)
        log.debug(
            "batch %d: %.3fs, %.2fM rays, %.1f Mrays/s, %.2f spp/s",
            batch, seconds, rays / 1e6, rec.mrays_per_sec, rec.spp_per_sec,
        )
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps({
                    "batch": batch, "seconds": seconds, "rays": rays,
                    "mrays_per_sec": rec.mrays_per_sec,
                    "spp_per_sec": rec.spp_per_sec,
                }) + "\n")
        return rec

    @property
    def total_rays(self) -> float:
        return sum(r.rays for r in self.records)

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.records)

    @property
    def mrays_per_sec(self) -> float:
        t = self.total_seconds
        return self.total_rays / t / 1e6 if t > 0 else 0.0
