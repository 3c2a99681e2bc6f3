"""Training metrics logging (PyTorch-side copy of vnl_tpu/utils/logging.py).

The metrics always stream to a JSONL file.  wandb (the upstream
reference's logger) is used only when ``use_wandb=True`` and it imports:
unlike the JAX package's logger, the default is off, because importing and
initialising wandb reaches for the network.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, project: str = "vnl_tpu_torch",
                 run_name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None,
                 out_dir: str = "./logs", use_wandb: bool = False):
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(project=project, name=run_name, config=config)
            except Exception:
                self._wandb = None
        os.makedirs(out_dir, exist_ok=True)
        stamp = run_name or time.strftime("%Y%m%d-%H%M%S")
        self._path = os.path.join(out_dir, f"metrics_{stamp}.jsonl")
        self._f = open(self._path, "a")
        if config is not None:
            self._f.write(json.dumps({"_config": _jsonable(config)}) + "\n")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {"_step": step, **_jsonable(metrics)}
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


def _jsonable(d: Any) -> Any:
    if isinstance(d, dict):
        return {k: _jsonable(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_jsonable(v) for v in d]
    try:
        return float(d)
    except (TypeError, ValueError):
        return str(d)
