"""Path-traced / shaded point-cloud renders (a copy of
``curvecloudnet_tpu/visualization/mitsuba_render.py``, on the host;
reference ``src/visualization/mitsuba_render.py:143-262``).

Two backends behind one API:

* ``mitsuba`` (optional dependency, ``scalar_rgb`` CPU variant like the
  reference): sphere per point + rectangle area light + ground plane,
  rendered by Mitsuba 3's path tracer.
* ``numpy`` (always available): a perspective z-buffered sphere-splat
  shader — per-pixel sphere normals with lambertian sun + ambient, gamma
  1/2.2 — matching the reference renders' look without the path-traced
  soft shadows.

Dataset presets reproduce the reference's scene normalization: KITTI
scales by 1/40 and offsets into the unit scene (mitsuba_render.py:146-147),
Audi scales by 1/30 with the yaw/pitch alignment (:186-196), ShapeNet uses
the (2.2, 2.2, 2.2) -> (0, 0, 0.5) look-at (:216-221).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _rot_z(a):
    return np.array([[np.cos(a), np.sin(a), 0],
                     [-np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)


def _rot_x(a):
    return np.array([[1, 0, 0], [0, np.cos(a), np.sin(a)],
                     [0, -np.sin(a), np.cos(a)]], np.float32)


class Preset:
    def __init__(self, transform, origin, target, fov, width, height, spp):
        self.transform = transform
        self.origin = origin
        self.target = target
        self.fov = fov
        self.width = width
        self.height = height
        self.spp = spp


PRESETS = {
    # reference render_pc_kitti:146-147,160
    "kitti": Preset(
        lambda pc: pc / 40.0 + np.array([[0.4, 0.35, 0.3]], np.float32),
        origin=(1.8, 1.8, 2.2), target=(0, 0, 0.5), fov=25,
        width=1000, height=1000, spp=16),
    # reference render_pc_audi:186-201 (yaw -2.6pi/4.6, pitch 0.03)
    "audi": Preset(
        lambda pc: (pc / 30.0) @ _rot_z(-2.6 * np.pi / 4.6) @ _rot_x(0.03)
        + np.array([[0.3, 0.9, 0.14]], np.float32),
        origin=(2.2, 2.2, 2.2), target=(0, 0, 0), fov=20,
        width=800, height=800, spp=64),
    # reference render_pc_shapenet:216-221
    "shapenet": Preset(
        lambda pc: np.asarray(pc, np.float32),
        origin=(2.2, 2.2, 2.2), target=(0, 0, 0.5), fov=25,
        width=800, height=680, spp=64),
    # reference kortx branch (:218)
    "kortx": Preset(
        lambda pc: np.asarray(pc, np.float32),
        origin=(2.2, 2.2, 2.2), target=(0, 0, 0), fov=25,
        width=800, height=680, spp=64),
}


def have_mitsuba() -> bool:
    try:
        import mitsuba  # noqa: F401

        return True
    except Exception:
        return False


# ---------------------------------------------------------------------------
# numpy fallback renderer
# ---------------------------------------------------------------------------

def _look_at(origin, target, up=(0, 0, 1)):
    o = np.asarray(origin, np.float32)
    fwd = np.asarray(target, np.float32) - o
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right /= np.linalg.norm(right)
    dn = np.cross(right, fwd)
    return o, right, dn, fwd


def render_numpy(points: np.ndarray, colors: np.ndarray, preset: Preset,
                 point_radius: float = 0.005,
                 light_dir=(-0.4, 0.3, -1.0),
                 background=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Z-buffered sphere splats with per-pixel normals (linear RGB out)."""
    o, right, dn, fwd = _look_at(preset.origin, preset.target)
    w, h = preset.width, preset.height
    f = 0.5 * w / np.tan(np.deg2rad(preset.fov) / 2)

    rel = points.astype(np.float32) - o
    cz = rel @ fwd                      # depth along view axis
    cx = rel @ right
    cy = rel @ dn
    vis = cz > 1e-4
    px = np.where(vis, cx / np.maximum(cz, 1e-6) * f + w / 2, -1)
    py = np.where(vis, -cy / np.maximum(cz, 1e-6) * f + h / 2, -1)
    pr = np.where(vis, point_radius / np.maximum(cz, 1e-6) * f, 0)

    img = np.ones((h, w, 3), np.float32) * np.asarray(background, np.float32)
    zbuf = np.full((h, w), np.inf, np.float32)
    ld = -np.asarray(light_dir, np.float32)
    ld /= np.linalg.norm(ld)
    # light direction in camera basis (normals are camera-space)
    ldc = np.array([ld @ right, ld @ dn, -(ld @ fwd)], np.float32)

    order = np.argsort(-cz)  # far-to-near; z-test still decides
    for i in order:
        if not vis[i] or pr[i] < 0.3:
            continue
        r = max(pr[i], 0.6)
        x0, x1 = int(px[i] - r), int(px[i] + r) + 1
        y0, y1 = int(py[i] - r), int(py[i] + r) + 1
        if x1 < 0 or y1 < 0 or x0 >= w or y0 >= h:
            continue
        x0c, y0c = max(x0, 0), max(y0, 0)
        x1c, y1c = min(x1, w), min(y1, h)
        ys, xs = np.mgrid[y0c:y1c, x0c:x1c]
        dx = (xs - px[i]) / r
        dy = (ys - py[i]) / r
        d2 = dx * dx + dy * dy
        inside = d2 <= 1.0
        if not inside.any():
            continue
        nz = np.sqrt(np.clip(1.0 - d2, 0, 1))
        z = cz[i] - nz * point_radius
        closer = inside & (z < zbuf[y0c:y1c, x0c:x1c])
        if not closer.any():
            continue
        lam = np.clip(dx * ldc[0] - dy * ldc[1] + nz * ldc[2], 0, 1)
        shade = (0.35 + 0.65 * lam)[..., None] * colors[i][None, None, :]
        patch = img[y0c:y1c, x0c:x1c]
        patch[closer] = shade[closer]
        zb = zbuf[y0c:y1c, x0c:x1c]
        zb[closer] = z[closer]
    return img


# ---------------------------------------------------------------------------
# mitsuba backend
# ---------------------------------------------------------------------------

def render_mitsuba(points: np.ndarray, colors: np.ndarray, preset: Preset,
                   point_radius: float = 0.005) -> np.ndarray:
    """Sphere-per-point path trace via Mitsuba 3 scalar_rgb
    (scene structure per reference mitsuba_render.py:96-141, 229-252)."""
    import mitsuba as mi

    mi.set_variant("scalar_rgb")
    scene = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {
            "type": "perspective",
            "fov": preset.fov,
            "to_world": mi.ScalarTransform4f.look_at(
                origin=preset.origin, target=preset.target, up=(0, 0, 1)),
            "sampler": {"type": "independent",
                        "sample_count": preset.spp},
            "film": {"type": "hdrfilm", "width": preset.width,
                     "height": preset.height, "rfilter": {"type": "gaussian"}},
        },
        "white": {"type": "diffuse",
                  "reflectance": {"type": "rgb", "value": [1, 1, 1]}},
        "ground": {
            "type": "rectangle",
            "to_world": mi.ScalarTransform4f.scale([30, 30, 1]),
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb", "value": [1, 1, 1]}},
        },
        "light": {
            "type": "rectangle",
            "to_world": mi.ScalarTransform4f.look_at(
                origin=(-4, 4, 20), target=(0, 0, 0),
                up=(0, 0, 1)) @ mi.ScalarTransform4f.scale([5, 5, 1]),
            "emitter": {"type": "area",
                        "radiance": {"type": "rgb", "value": [17, 17, 17]}},
        },
    }
    for i in range(len(points)):
        scene[f"point-{i}"] = {
            "type": "sphere",
            "center": [float(points[i, 0]), float(points[i, 1]),
                       float(points[i, 2])],
            "radius": float(point_radius),
            "bsdf": {"type": "diffuse",
                     "reflectance": {"type": "rgb",
                                     "value": [float(colors[i, 0]),
                                               float(colors[i, 1]),
                                               float(colors[i, 2])]}},
        }
    img = mi.render(mi.load_dict(scene))
    return np.asarray(img)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def render_points(pos, colors, preset: str = "shapenet",
                  point_radius: float = 0.005, backend: str = "auto",
                  max_points: int = 20000, valid=None) -> np.ndarray:
    """Render a point cloud; returns a gamma-corrected (H, W, 3) image in
    [0, 1].  ``backend``: "auto" uses mitsuba when installed."""
    p = PRESETS[preset]
    pos = np.asarray(pos, np.float32)
    colors = np.asarray(colors, np.float32)
    if valid is not None:
        m = np.asarray(valid, bool)
        pos, colors = pos[m], colors[m]
    if len(pos) > max_points:
        sel = np.random.default_rng(0).choice(len(pos), max_points,
                                              replace=False)
        pos, colors = pos[sel], colors[sel]
    pos = p.transform(pos)
    use_mi = backend == "mitsuba" or (backend == "auto" and have_mitsuba())
    img = (render_mitsuba(pos, colors, p, point_radius) if use_mi
           else render_numpy(pos, colors, p, point_radius))
    return np.clip(img, 0, 1) ** (1.0 / 2.2)


def render_segmentation_panels(pos, pred, gt, colormap, preset="kitti",
                               valid=None, point_radius: float = 0.005,
                               backend: str = "auto") -> np.ndarray:
    """Side-by-side prediction / ground-truth render (the
    visualize_mitsuba.py:10-87 seg panels).  ``colormap``: (C, 3) in [0,1]."""
    cm = np.asarray(colormap, np.float32)
    pred_c = cm[np.clip(np.asarray(pred), 0, len(cm) - 1)]
    gt_c = cm[np.clip(np.asarray(gt), 0, len(cm) - 1)]
    a = render_points(pos, pred_c, preset, point_radius, backend, valid=valid)
    b = render_points(pos, gt_c, preset, point_radius, backend, valid=valid)
    return np.concatenate([a, b], axis=1)


def save_png(img: np.ndarray, path: str) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imsave(path, np.clip(img, 0, 1))
    return path
