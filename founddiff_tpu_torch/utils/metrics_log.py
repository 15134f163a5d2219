"""Structured metrics logging (mirror of ``founddiff_tpu/utils/metrics_log.py``;
the reference's optional wandb hooks, src/DADiff.py:1575,1678-1760).

Always writes JSONL (offline-safe, consumed by tools/analyze_results.py);
mirrors to wandb when the package is importable and ``use_wandb=True``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, path: str, use_wandb: bool = False,
                 project: str = "founddiff_tpu", name: Optional[str] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project, name=name)
                self._wandb = wandb
            except ImportError:
                pass

    def log(self, metrics: Dict[str, float], step: Optional[int] = None):
        rec = {"time": time.time(), **({"step": step} if step is not None else {}),
               **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        self._f.close()
