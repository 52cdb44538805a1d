"""wandb reporting with a dependency-free offline fallback.

The port's copy of ``xclip_tpu/utils/wandb_logger.py`` (no JAX there, but
the port imports nothing of the JAX package). The reference gates wandb
behind ``--report-to wandb`` (training/main.py:119-121,388-411) and logs
each train/eval metric window via ``wandb.log`` (training/train.py:241-248).
:func:`init_wandb` returns the real ``wandb`` module when it imports and
its ``init`` works, and otherwise an :class:`OfflineWandbRun` that records
the same stream to plain files under ``<logs>/<name>/wandb-offline/``:

- ``config.json``   — the run config (flattened argparse namespace)
- ``history.jsonl`` — one JSON object per ``log()`` call (with ``_step``)
- ``summary.json``  — last value per key, written on ``finish()``
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional


def _jsonable(v: Any):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


class OfflineWandbRun:
    """File-backed stand-in for a ``wandb`` run (``log`` and ``finish``)."""

    def __init__(self, out_dir: str, config: Optional[Dict[str, Any]] = None):
        self.dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._history = open(os.path.join(out_dir, "history.jsonl"), "a")
        self._summary: Dict[str, Any] = {}
        self._step = 0
        if config is not None:
            with open(os.path.join(out_dir, "config.json"), "w") as fh:
                json.dump({k: _jsonable(v) for k, v in config.items()}, fh, indent=2, sort_keys=True)

    def log(self, data: Dict[str, Any], step: Optional[int] = None) -> None:
        if step is not None:
            self._step = int(step)
        row = {"_step": self._step}
        row.update({k: _jsonable(v) for k, v in data.items()})
        self._history.write(json.dumps(row) + "\n")
        self._history.flush()
        self._summary.update(row)
        if step is None:
            self._step += 1

    def finish(self) -> None:
        with open(os.path.join(self.dir, "summary.json"), "w") as fh:
            json.dump(self._summary, fh, indent=2, sort_keys=True)
        self._history.close()


def init_wandb(args, log_base_path: str):
    """Start a wandb run (the real package if importable, offline otherwise),
    as the reference does (training/main.py:388-411): project, name and id
    from the experiment, ``resume='auto'`` under ``--resume latest``, the
    args namespace as config. Returns an object with ``log(dict, step=)``
    and ``finish()``."""
    config = dict(vars(args))
    try:
        import wandb  # type: ignore

        if not callable(getattr(wandb, "init", None)):
            raise ImportError("wandb module has no usable init()")
        wandb.init(
            project=args.wandb_project_name,
            name=args.name,
            id=args.name,
            notes=args.wandb_notes,
            tags=[],
            resume="auto" if args.resume == "latest" else None,
            config=config,
        )
        logging.info("wandb initialized (project=%s)", args.wandb_project_name)
        return wandb
    except Exception as exn:  # unavailable, unusable, or init failed offline
        out_dir = os.path.join(log_base_path, "wandb-offline")
        logging.info("wandb unavailable (%s); recording the metric stream offline to %s", exn, out_dir)
        return OfflineWandbRun(out_dir, config=config)
