"""Metric logging to an append-only ``metrics.jsonl``, and to Weights &
Biases when asked and available (counterpart of
``curvecloudnet_tpu/logging_utils.py``).

The reference logs to Weights & Biases; this logger keeps its call shape
(``log(dict)``, summary maxima, run history) and writes one JSON line a
call that tooling can tail.  wandb is not a dependency of the port: with
``use_wandb=True`` the logger also logs to wandb if it imports and its
run starts, and otherwise prints one line and carries on with
``metrics.jsonl`` alone, as the JAX package's logger does.  With more
than one process only process 0 writes (the file, wandb, media); every
process keeps the history.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from . import parallel


class MetricLogger:
    def __init__(self, outdir: Optional[str] = None, use_wandb: bool = False,
                 config: Optional[dict] = None,
                 project: str = "curvecloudnet-tpu"):
        self.outdir = outdir
        self._fh = None
        self._wandb = None
        self.summary_max: Dict[str, float] = {}
        self._history: Dict[str, list] = {}
        self.primary = parallel.is_primary()
        if outdir and self.primary:
            os.makedirs(outdir, exist_ok=True)
            self._fh = open(os.path.join(outdir, "metrics.jsonl"), "a")
        if use_wandb and self.primary:
            try:
                import wandb

                wandb.init(project=project, config=config or {})
                self._wandb = wandb
            except Exception as e:  # not installed, offline, no login
                print(f"[logging] wandb unavailable ({e}); using JSONL only")

    def reload_history(self) -> None:
        """Rebuild the in-memory history from this outdir's
        ``metrics.jsonl``, so a resumed run's run-spanning statistics
        (``median_top_k``, summary maxima) see the entries before the
        resume."""
        path = os.path.join(self.outdir or "", "metrics.jsonl")
        if not self.outdir or not os.path.exists(path):
            return
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                for k, v in rec.items():
                    if k in ("ts", "step") or not isinstance(v, (int, float)):
                        continue
                    self.summary_max[k] = max(
                        self.summary_max.get(k, -1e30), v)
                    self._history.setdefault(k, []).append(v)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {"ts": time.time()}
        if step is not None:
            rec["step"] = step
        for k, v in metrics.items():
            if hasattr(v, "item"):
                v = v.item()
            rec[k] = v
            if isinstance(v, (int, float)):
                self.summary_max[k] = max(self.summary_max.get(k, -1e30), v)
                self._history.setdefault(k, []).append(v)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._wandb:
            self._wandb.log(metrics, step=step)

    def log_media(self, name: str, obj, step: Optional[int] = None) -> None:
        """Persist a figure or image under ``<outdir>/media/`` and record
        its path: a plotly figure (.html), a matplotlib figure (.png,
        closed after saving), an HxWx3 numpy image, or a file path
        (copied)."""
        import numpy as np

        if not self.outdir or not self.primary:
            return
        media = os.path.join(self.outdir, "media")
        os.makedirs(media, exist_ok=True)
        tag = name.replace("/", "_") + ("" if step is None else f"_{step}")
        if hasattr(obj, "to_plotly_json"):
            path = os.path.join(media, tag + ".html")
            obj.write_html(path)
        elif hasattr(obj, "savefig"):
            import matplotlib.pyplot as plt

            path = os.path.join(media, tag + ".png")
            obj.savefig(path, dpi=150)
            plt.close(obj)
        elif isinstance(obj, np.ndarray):
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            path = os.path.join(media, tag + ".png")
            plt.imsave(path, np.clip(obj, 0, 1))
        elif isinstance(obj, (str, os.PathLike)) and os.path.exists(obj):
            import shutil

            ext = os.path.splitext(str(obj))[1] or ".png"
            path = os.path.join(media, tag + ext)
            shutil.copyfile(obj, path)
        else:
            path = str(obj)
        self.log({f"media/{name}": path}, step=step)

    def median_top_k(self, key: str, k: int = 5) -> float:
        """The reference's 'Median Top 5 IOU' over the run's logged values
        (nuscenes_seg.py:159-161)."""
        import numpy as np

        vals = sorted(self._history.get(key, []))[-k:]
        return float(np.median(vals)) if vals else float("nan")

    def close(self):
        if self._fh:
            self._fh.close()
        if self._wandb:
            self._wandb.finish()
