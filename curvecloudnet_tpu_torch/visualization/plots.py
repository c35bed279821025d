"""Point-cloud / curve / segmentation figures (a copy of
``curvecloudnet_tpu/visualization/plots.py``, on the host).

Capability parallel of the reference's visualization stack
(``src/visualization/visualize_plotly.py`` interactive figures and the
Mitsuba path-traced renders, SURVEY.md §2.9).  This environment has neither
plotly nor Mitsuba, so the default backend is matplotlib (always available);
``to_plotly_figure`` upgrades to interactive HTML when plotly is installed.
All functions accept padded arrays + validity masks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _unpad(pos, valid, *extras):
    pos = np.asarray(pos)
    if valid is not None:
        m = np.asarray(valid).astype(bool)
        return (pos[m],) + tuple(
            None if e is None else np.asarray(e)[m] for e in extras)
    return (pos,) + tuple(None if e is None else np.asarray(e)
                          for e in extras)


def plot_curve_cloud(pos, curve_id, valid=None, path: str = "curves.png",
                     max_points: int = 60000, elev: float = 25,
                     azim: float = 45, point_size: float = 0.8):
    """3D scatter colored by curve id (parallel of the datasets' debug viz,
    reference kitti_dataset.py:154-168)."""
    plt = _mpl()
    pos, cid = _unpad(pos, valid, curve_id)
    if len(pos) > max_points:
        sel = np.random.default_rng(0).choice(len(pos), max_points, False)
        pos, cid = pos[sel], cid[sel]
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    colors = (cid * 0.61803398875) % 1.0  # golden-ratio hue scatter
    ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c=colors, cmap="hsv",
               s=point_size, linewidths=0)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    fig.tight_layout()
    if path is None:
        return fig  # caller (e.g. MetricLogger.log_media) owns saving
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_segmentation(pos, pred, gt=None, valid=None,
                      cmap: Optional[np.ndarray] = None,
                      path: str = "seg.png", max_points: int = 60000,
                      point_size: float = 0.8):
    """Prediction (and optional GT) 3D scatter panels
    (reference visualize_plotly.py seg comparisons)."""
    plt = _mpl()
    pos, pred, gt = _unpad(pos, valid, pred, gt)
    if len(pos) > max_points:
        sel = np.random.default_rng(0).choice(len(pos), max_points, False)
        pos, pred = pos[sel], pred[sel]
        gt = None if gt is None else gt[sel]
    panels = [("pred", pred)] + ([("gt", gt)] if gt is not None else [])
    fig = plt.figure(figsize=(8 * len(panels), 8))
    for i, (name, lab) in enumerate(panels):
        ax = fig.add_subplot(1, len(panels), i + 1, projection="3d")
        if cmap is not None:
            c = np.asarray(cmap)[np.clip(lab, 0, len(cmap) - 1)]
            ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c=c, s=point_size,
                       linewidths=0)
        else:
            ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c=lab, cmap="tab20",
                       s=point_size, linewidths=0)
        ax.set_title(name)
        ax.set_axis_off()
    fig.tight_layout()
    if path is None:
        return fig  # caller (e.g. MetricLogger.log_media) owns saving
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def render_bev(pos, labels, valid=None, res: int = 512, extent: float = 3.0,
               path: Optional[str] = None) -> np.ndarray:
    """Fast bird's-eye-view label raster for lidar scenes (returns (res,res)
    int image; useful for quick eval sanity checks and wandb logging)."""
    pos, lab = _unpad(pos, valid, labels)
    img = np.zeros((res, res), np.int32)
    xy = np.clip(((pos[:, :2] + extent) / (2 * extent) * res), 0,
                 res - 1).astype(int)
    img[xy[:, 1], xy[:, 0]] = lab + 1
    if path:
        plt = _mpl()
        plt.imsave(path, img, cmap="tab20")
    return img


def label_colormap(n: int) -> np.ndarray:
    """Deterministic (n, 3) label colormap in [0, 1] (golden-angle HSV
    cycle — same role as the reference's per-dataset colormap tables in
    src/run/globals.py; class 0 renders dark grey like its ignore color)."""
    import colorsys

    out = np.zeros((max(n, 1), 3), np.float32)
    out[0] = (0.25, 0.25, 0.25)
    for i in range(1, n):
        h = (i * 0.61803398875) % 1.0
        out[i] = colorsys.hsv_to_rgb(h, 0.75, 0.95)
    return out


def plot_confusion(confmat, class_names: Optional[Sequence[str]] = None,
                   path: Optional[str] = "confusion.png"):
    """Row-normalized confusion matrix heatmap
    (reference shapenet_classification.py:104-116)."""
    plt = _mpl()
    cm = np.asarray(confmat, np.float64)
    norm = cm / np.maximum(cm.sum(1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(norm, cmap="viridis", vmin=0, vmax=1)
    if class_names:
        ax.set_xticks(range(len(class_names)))
        ax.set_yticks(range(len(class_names)))
        ax.set_xticklabels(class_names, rotation=90, fontsize=7)
        ax.set_yticklabels(class_names, fontsize=7)
    ax.set_xlabel("pred")
    ax.set_ylabel("true")
    fig.tight_layout()
    if path is None:
        return fig  # caller (e.g. MetricLogger.log_media) owns saving
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def grouping_edges_figure(pos, nbr_idx, query_pos=None, valid=None,
                          max_edges: int = 4000, path: Optional[str] = None,
                          title: str = "groupings"):
    """Neighbor-grouping edge graph (reference
    ``visualize_plotly.py:284-306`` draws each grouping edge as a 3D line
    from query to neighbor).  Returns a plotly Figure when plotly is
    installed; otherwise renders a matplotlib Line3D fallback to ``path``
    (and returns the path).

    pos: (N, 3) candidate points; nbr_idx: (Q, K) with -1 padding;
    query_pos: (Q, 3) (defaults to pos rows — same-set grouping).
    """
    pos = np.asarray(pos, np.float32)
    nbr = np.asarray(nbr_idx)
    qpos = pos if query_pos is None else np.asarray(query_pos, np.float32)
    qs, js = np.nonzero(nbr >= 0)
    tgt = nbr[qs, js]
    if valid is not None:
        m = np.asarray(valid, bool)
        keep = m[tgt]
        qs, tgt = qs[keep], tgt[keep]
    if len(qs) > max_edges:
        sel = np.random.default_rng(0).choice(len(qs), max_edges,
                                              replace=False)
        qs, tgt = qs[sel], tgt[sel]
    a, b = qpos[qs], pos[tgt]

    try:
        import plotly.graph_objects as go

        # one trace with None separators — the plotly idiom for segments
        xs = np.stack([a[:, 0], b[:, 0], np.full(len(a), np.nan)], -1).ravel()
        ys = np.stack([a[:, 1], b[:, 1], np.full(len(a), np.nan)], -1).ravel()
        zs = np.stack([a[:, 2], b[:, 2], np.full(len(a), np.nan)], -1).ravel()
        fig = go.Figure(data=[
            go.Scatter3d(x=xs, y=ys, z=zs, mode="lines",
                         line=dict(width=1, color="rgba(60,60,200,0.4)"),
                         name="edges"),
            go.Scatter3d(x=qpos[:, 0], y=qpos[:, 1], z=qpos[:, 2],
                         mode="markers", marker=dict(size=2, color="red"),
                         name="queries"),
        ])
        fig.update_layout(title=title)
        return fig
    except ImportError:
        pass
    plt = _mpl()
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.add_collection3d(Line3DCollection(
        np.stack([a, b], axis=1), linewidths=0.3, colors=(0.2, 0.2, 0.8, 0.4)))
    ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], s=0.5, c="gray")
    lo, hi = pos.min(0), pos.max(0)
    ax.set_xlim(lo[0], hi[0]); ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(lo[2], hi[2])
    ax.set_title(title)
    out = path or "groupings.png"
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def vector_cones_figure(pos, vecs, valid=None, title: str = "vectors",
                        max_points: int = 4000, path: Optional[str] = None):
    """Per-point direction field as cones/quiver (reference
    ``visualize_plotly.py:19-49`` renders normals and curve directions as
    ``go.Cone`` traces).  Plotly Cone figure when plotly is installed,
    matplotlib 3D quiver to ``path`` otherwise.

    pos: (N, 3); vecs: (N, 3) direction per point (e.g. predicted normals
    or curve tangents).
    """
    pos, v = _unpad(pos, valid, vecs)
    if len(pos) > max_points:
        sel = np.random.default_rng(0).choice(len(pos), max_points, False)
        pos, v = pos[sel], v[sel]
    try:
        import plotly.graph_objects as go

        fig = go.Figure(data=[go.Cone(
            x=pos[:, 0], y=pos[:, 1], z=pos[:, 2],
            u=v[:, 0], v=v[:, 1], w=v[:, 2],
            sizemode="scaled", sizeref=8.0)])
        fig.update_layout(title_text=title, scene_aspectmode="cube")
        return fig
    except ImportError:
        pass
    plt = _mpl()
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.quiver(pos[:, 0], pos[:, 1], pos[:, 2],
              v[:, 0], v[:, 1], v[:, 2], length=0.05, linewidth=0.4,
              normalize=True)
    ax.set_title(title)
    ax.set_axis_off()
    out = path or "cones.png"
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def _unit_box_edges(offset=(0.0, 0.0, 0.0)):
    """12 wireframe edges of the unit cube at ``offset`` (N-separated)."""
    c = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                  for z in (0, 1)], np.float32) + np.asarray(offset)
    pairs = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    return np.array([c[a] for a, b in pairs]), np.array(
        [c[b] for a, b in pairs])


def nocs_figure(pos, pred_nocs, gt_nocs, errs=None, max_err: float = 0.1,
                title: str = "NOCS prediction error",
                path: Optional[str] = None):
    """NOCS prediction panels: input cloud colored by error, predicted and
    GT normalized-object coordinates side by side inside unit-box wireframes
    (reference ``visualize_plotly.py:106-160,308-327`` /
    ``visualize_mitsuba.py:10-30``).

    pos/pred_nocs/gt_nocs: (N, 3); errs: (N,) per-point L1 error (defaults
    to |pred - gt| mean).  NOCS values are in [-0.5, 0.5]; panels are shifted
    along +x like the reference (input at 0, pred at +1.2, GT at +2.4).
    """
    pos = np.asarray(pos, np.float32)
    pred = np.asarray(pred_nocs, np.float32) + 0.5
    gt = np.asarray(gt_nocs, np.float32) + 0.5
    if errs is None:
        errs = np.abs(pred - gt).mean(-1)
    errs = np.clip(np.asarray(errs, np.float32) / max_err, 0, 1)
    err_c = np.stack([errs, 1.0 - errs, np.zeros_like(errs)], -1)
    panels = [(pos - pos.mean(0) + np.array([0.5, 0.5, 0.5]), err_c),
              (pred + np.array([1.2, 0, 0]), np.clip(pred, 0, 1)),
              (gt + np.array([2.4, 0, 0]), np.clip(gt, 0, 1))]
    boxes = [_unit_box_edges((dx, 0, 0)) for dx in (0.0, 1.2, 2.4)]
    try:
        import plotly.graph_objects as go

        data = []
        for p, c in panels:
            rgb = [f"rgb({int(r*255)},{int(g*255)},{int(b*255)})"
                   for r, g, b in c]
            data.append(go.Scatter3d(x=p[:, 0], y=p[:, 1], z=p[:, 2],
                                     mode="markers",
                                     marker=dict(size=2, color=rgb)))
        xs, ys, zs = [], [], []
        for a, b in boxes:
            for s, e in zip(a, b):
                xs += [s[0], e[0], None]
                ys += [s[1], e[1], None]
                zs += [s[2], e[2], None]
        data.append(go.Scatter3d(x=xs, y=ys, z=zs, mode="lines",
                                 line=dict(color="rgb(70,70,70)", width=1)))
        fig = go.Figure(data=data)
        fig.update_layout(title=title, scene_aspectmode="data")
        return fig
    except ImportError:
        pass
    plt = _mpl()
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    fig = plt.figure(figsize=(12, 5))
    ax = fig.add_subplot(projection="3d")
    for p, c in panels:
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], c=c, s=1.5, linewidths=0)
    for a, b in boxes:
        ax.add_collection3d(Line3DCollection(
            np.stack([a, b], axis=1), linewidths=0.5,
            colors=(0.3, 0.3, 0.3, 0.8)))
    ax.set_xlim(-0.2, 3.6); ax.set_ylim(-0.2, 1.2); ax.set_zlim(-0.2, 1.2)
    ax.set_title(title)
    ax.set_axis_off()
    out = path or "nocs.png"
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def to_plotly_figure(pos, labels, valid=None):
    """Interactive 3D figure when plotly is available (optional dep)."""
    try:
        import plotly.graph_objects as go
    except ImportError:
        return None
    pos, lab = _unpad(pos, valid, labels)
    return go.Figure(data=[go.Scatter3d(
        x=pos[:, 0], y=pos[:, 1], z=pos[:, 2], mode="markers",
        marker=dict(size=1.5, color=lab, colorscale="Turbo"))])
