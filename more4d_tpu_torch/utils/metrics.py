"""Scalar metrics logging for the trainers (PyTorch port of
``more4d_tpu/utils/metrics.py``): an append-only JSONL stream, one record
per call, ``{"step": ..., "time": ..., "<prefix>/<name>": value, ...}``.
The JAX package's optional TensorBoard mirror is not ported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, output_dir: str, name: str = "metrics"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{name}.jsonl")
        self._fh = open(self.path, "a")

    def log(self, step: int, scalars: Dict[str, float],
            prefix: Optional[str] = None) -> None:
        clean = {}
        for k, v in scalars.items():
            key = f"{prefix}/{k}" if prefix else k
            try:
                clean[key] = float(v)
            except (TypeError, ValueError):
                continue
        rec = {"step": int(step), "time": time.time(), **clean}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
