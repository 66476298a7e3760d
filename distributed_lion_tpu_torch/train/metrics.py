"""Metrics logging to stdout and JSONL: port of ``distributed_lion_tpu/train/metrics.py``.

The console line goes through ``train.journal.emit`` with ``record=False``:
its durable form is ``metrics.jsonl``, so the rows are not copied into the
run journal. wandb is not ported (the port logs locally only).
"""

from __future__ import annotations

import json
import math
import pathlib
import time
from typing import Optional

from distributed_lion_tpu_torch.train.journal import emit


class MetricsLogger:
    def __init__(self, output_dir: Optional[str] = None):
        self.jsonl = None
        if output_dir:
            path = pathlib.Path(output_dir)
            path.mkdir(parents=True, exist_ok=True)
            self.jsonl = open(path / "metrics.jsonl", "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, prefix: str = "train") -> None:
        record = {"step": step, "elapsed_s": round(time.time() - self._t0, 3)}
        sep = "/" if prefix else ""
        record.update({f"{prefix}{sep}{k}": _scalar(v) for k, v in metrics.items()})
        emit(" ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                      for k, v in record.items()), record=False)
        if self.jsonl:
            # allow_nan=False: a bare NaN token is not JSON
            self.jsonl.write(json.dumps(jsonable_record(record), allow_nan=False) + "\n")

    def close(self) -> None:
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def jsonable_record(record: dict) -> dict:
    """Strict-JSON view: non-finite floats become null, with the raw value
    kept under ``"<k>_repr"``."""
    out: dict = {}
    for k, v in record.items():
        if isinstance(v, float) and not math.isfinite(v):
            out[k] = None
            out[f"{k}_repr"] = repr(v)
        else:
            out[k] = v
    return out
