"""QA renders for generated scan datasets (simulator stage 4.5; a copy of
``curvecloudnet_tpu/simulator/qa_viz.py`` on the port's visualization).

Parallel of the reference's generation-time QA hooks
(``scanning_simulator/utils/visualization.py:10-153``):

  * ``visualize_scan_labels`` — generated scan colored by transferred part
    labels next to the label-source cloud (``visualize_shapenet_pc``,
    visualization.py:10-62; the reference writes either a plotly HTML or a
    mitsuba NOCS render — here one PNG panel via the shared renderer, which
    picks real mitsuba when installed and the numpy sphere-splat otherwise).
  * ``visualize_scan_curves`` — points colored by a stable per-curve hash
    (``visualize_kortx_pc_mitsuba`` with ``use_vivid=True``,
    visualization.py:92-99: r/g/b = hash(str(idx)+salt) % 256 / 255).

Both return the image arrays so tests can assert content without touching
disk; the generator CLI writes them next to the dataset shard.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..visualization.mitsuba_render import render_points, save_png


def curve_hash_colors(curve_id: np.ndarray) -> np.ndarray:
    """Stable vivid per-curve colors, the reference's string-hash scheme
    (visualization.py:93-96) with a deterministic hash (python's ``hash``
    is salted per process; md5 keeps renders reproducible)."""
    import hashlib

    cid = np.asarray(curve_id).astype(np.int64)
    uniq, inv = np.unique(cid, return_inverse=True)
    table = np.empty((len(uniq), 3), np.float32)
    for i, u in enumerate(uniq):
        for c, salt in enumerate(("rd", "grn", "bl")):
            h = hashlib.md5(f"{u}{salt}".encode()).digest()
            table[i, c] = (h[0] % 256) / 255.0
    return table[inv]


def label_part_colors(labels: np.ndarray) -> np.ndarray:
    """tab20b-style qualitative colors by label rank (visualization.py:38-40)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    lab = np.asarray(labels)
    uniq, inv = np.unique(lab, return_inverse=True)
    cmap = plt.get_cmap("tab20b")
    return cmap(inv / max(len(uniq), 1))[:, :3].astype(np.float32)


def visualize_scan_labels(pos: np.ndarray, labels: np.ndarray,
                          label_pos: Optional[np.ndarray] = None,
                          label_lab: Optional[np.ndarray] = None,
                          path: Optional[str] = None,
                          backend: str = "auto") -> np.ndarray:
    """Scan colored by part labels, side by side with the label-source cloud
    when given (the reference concatenates both clouds into one figure,
    visualization.py:42-45)."""
    img = render_points(pos, label_part_colors(labels), preset="shapenet",
                        backend=backend)
    if label_pos is not None and label_lab is not None:
        ref = render_points(label_pos, label_part_colors(label_lab),
                            preset="shapenet", backend=backend)
        img = np.concatenate([img, ref], axis=1)
    if path:
        save_png(img, path)
    return img


def visualize_scan_curves(pos: np.ndarray, curve_id: np.ndarray,
                          path: Optional[str] = None,
                          backend: str = "auto") -> np.ndarray:
    """Points colored by per-curve hash colors (visualization.py:92-121)."""
    img = render_points(pos, curve_hash_colors(curve_id), preset="shapenet",
                        backend=backend)
    if path:
        save_png(img, path)
    return img


def write_qa_panels(outdir: str, index: int, pos: np.ndarray,
                    curve_id: np.ndarray, labels: Optional[np.ndarray],
                    label_pos: Optional[np.ndarray] = None,
                    label_lab: Optional[np.ndarray] = None,
                    backend: str = "auto") -> list:
    """Write the per-sample QA panel set; returns the written paths."""
    os.makedirs(outdir, exist_ok=True)
    paths = []
    p = os.path.join(outdir, f"curves_{index}.png")
    visualize_scan_curves(pos, curve_id, p, backend=backend)
    paths.append(p)
    if labels is not None:
        p = os.path.join(outdir, f"seg_{index}.png")
        visualize_scan_labels(pos, labels, label_pos, label_lab, p,
                              backend=backend)
        paths.append(p)
    return paths
