"""Synthetic rotating-lidar sweeps and object scans, the inputs of the
serving slices.

Counterpart of ``synthetic_lidar_sweep`` / ``synthetic_lidar_batch`` and
``synthetic_object_scan`` / ``synthetic_object_batch`` in
``curvecloudnet_tpu/data/synthetic.py``: the same numpy draws in the same
order, so one seed gives both packages the same scan, value for value.
Each beam of the sensor is one curve, its points in azimuth order; a ground
plane, walls bounding the range per azimuth sector, and a few round objects
give spatially structured labels.  Positions are scaled by 1/20 as the
lidar datasets are.
"""

from __future__ import annotations

import numpy as np

N_OBJECTS = 6
N_SECTORS = 64
SENSOR_HEIGHT = 1.8   # metres above the ground plane
MAX_RANGE = 60.0
RANGE_NOISE = 0.03    # metres, additive


def lidar_sweep(rng: np.random.Generator, n_points: int, n_beams: int = 32,
                n_classes: int = 17, pos_scale: float = 1.0 / 20.0):
    """One sweep -> (pos (N, 3) f32, reflectance (N, 1) f32, curve_id (N,)
    i32, labels (N,) i32), N = n_beams * (n_points // n_beams)."""
    per_beam = n_points // n_beams
    elevation = np.deg2rad(np.linspace(-25, 5, n_beams))
    obj_xy = rng.uniform(-30, 30, size=(N_OBJECTS, 2))
    obj_r = rng.uniform(1.5, 4.0, size=N_OBJECTS)
    obj_c = rng.integers(1, n_classes, size=N_OBJECTS)
    wall_r = rng.uniform(8.0, 55.0, size=N_SECTORS)
    # range at which each object's surface is hit
    obj_hit_r = [np.clip(np.linalg.norm(c) - r, 1.0, MAX_RANGE)
                 for c, r in zip(obj_xy, obj_r)]
    wall_class = min(2, n_classes - 1)
    pos, labels = [], []
    for el in elevation:
        az = np.sort(rng.uniform(0, 2 * np.pi, per_beam))
        ground_r = (min(SENSOR_HEIGHT / np.tan(-el), MAX_RANGE)
                    if el < -1e-3 else MAX_RANGE)
        sector = (az / (2 * np.pi) * N_SECTORS).astype(int) % N_SECTORS
        bound = wall_r[sector] * rng.uniform(0.97, 1.03, per_beam)
        r = (np.minimum(np.full(per_beam, ground_r), bound)
             + rng.normal(0.0, RANGE_NOISE, per_beam))
        xy = np.stack([r * np.cos(az), r * np.sin(az)], -1)
        lab = np.where(bound < ground_r, wall_class, 1).astype(np.int32)
        # objects in order, a later one overriding an earlier: one noise
        # draw per object for every point, hit or not
        for o in range(N_OBJECTS):
            hit = np.linalg.norm(xy - obj_xy[o], axis=-1) < obj_r[o]
            r = np.where(hit, obj_hit_r[o]
                         + rng.normal(0.0, RANGE_NOISE, per_beam), r)
            lab = np.where(hit, obj_c[o], lab)
        z = SENSOR_HEIGHT + r * np.tan(el)
        pos.append(np.stack([r * np.cos(az), r * np.sin(az), z], -1))
        labels.append(lab)
    pos = np.concatenate(pos).astype(np.float32) * pos_scale
    curve_id = np.repeat(np.arange(n_beams, dtype=np.int32), per_beam)
    refl = rng.uniform(0, 1, size=(len(pos), 1)).astype(np.float32)
    return pos, refl, curve_id, np.concatenate(labels).astype(np.int32)


def lidar_batch(rng: np.random.Generator, batch: int, n_pad: int,
                n_points: int | None = None, n_beams: int = 32,
                n_classes: int = 17):
    """``batch`` sweeps padded to ``n_pad`` rows -> (pos, feat, curve_id,
    valid, labels).  Row 0 has ``n_points`` points (default ``n_pad``), the
    others a random 90-100% of that."""
    n_points = n_pad if n_points is None else n_points
    pos = np.zeros((batch, n_pad, 3), np.float32)
    feat = np.zeros((batch, n_pad, 1), np.float32)
    curve_id = np.zeros((batch, n_pad), np.int32)
    valid = np.zeros((batch, n_pad), bool)
    labels = np.zeros((batch, n_pad), np.int32)
    for i in range(batch):
        n_i = n_points if i == 0 else int(
            rng.integers(int(n_points * 0.9), n_points + 1))
        p, f, c, y = lidar_sweep(rng, min(n_i, n_pad), n_beams, n_classes)
        m = len(p)
        pos[i, :m], feat[i, :m], curve_id[i, :m], labels[i, :m] = p, f, c, y
        valid[i, :m] = True
    return pos, feat, curve_id, valid, labels


OBJECT_SHAPES = ("sphere", "cylinder", "box")


def object_scan(rng: np.random.Generator, n_points: int, n_lines: int = 24,
                n_parts: int = 4, shape: str | None = None):
    """One scanned object, the counterpart of ``synthetic_object_scan``:
    parallel scan lines (one curve each) over a half sphere, a half
    cylinder or a box's front face and top, centred and scaled into the
    unit sphere as the object datasets are.  -> (pos (N, 3) f32, curve_id
    (N,) i32, part labels (N,) i32 by height, category: the shape's index
    in ``OBJECT_SHAPES``), N = n_lines * (n_points // n_lines)."""
    if shape is None:
        shape = OBJECT_SHAPES[int(rng.integers(len(OBJECT_SHAPES)))]
    category = OBJECT_SHAPES.index(shape)
    per_line = n_points // n_lines
    pos, curve_id, labels = [], [], []
    for li, v in enumerate(np.linspace(-0.9, 0.9, n_lines)):
        t = np.linspace(0, 1, per_line) + rng.normal(0, 0.002, per_line)
        if shape == "sphere":
            phi = np.arccos(np.clip(v, -1, 1))
            theta = t * np.pi            # the visible half
            p = np.stack([np.sin(phi) * np.cos(theta),
                          np.sin(phi) * np.sin(theta),
                          np.full_like(theta, np.cos(phi))], -1)
        elif shape == "cylinder":
            theta = t * np.pi
            p = np.stack([np.cos(theta), np.sin(theta),
                          np.full_like(theta, v)], -1)
        else:                            # box front face + top
            x = t * 2 - 1
            p = np.stack([x, np.full_like(x, 0.5 * np.sign(v)),
                          np.full_like(x, v)], -1)
        pos.append(p)
        curve_id.append(np.full(per_line, li, np.int32))
        labels.append(np.digitize(p[:, 2],
                                  np.linspace(-1, 1, n_parts + 1)[1:-1]))
    pos = np.concatenate(pos).astype(np.float32)
    pos = pos - pos.mean(0, keepdims=True)
    pos = pos / max(np.linalg.norm(pos, axis=1).max(), 1e-6)
    pos += rng.normal(0, 0.005, pos.shape).astype(np.float32)
    return (pos.astype(np.float32), np.concatenate(curve_id),
            np.concatenate(labels).astype(np.int32), category)


def object_batch(rng: np.random.Generator, batch: int, n_pad: int,
                 n_parts: int = 4):
    """``batch`` object scans padded to ``n_pad`` rows, the counterpart of
    ``synthetic_object_batch`` -> (pos, curve_id, valid, part labels,
    categories (B,) i32)."""
    pos = np.zeros((batch, n_pad, 3), np.float32)
    curve_id = np.zeros((batch, n_pad), np.int32)
    valid = np.zeros((batch, n_pad), bool)
    part_labels = np.zeros((batch, n_pad), np.int32)
    categories = np.zeros((batch,), np.int32)
    for i in range(batch):
        p, c, y, cat = object_scan(rng, n_pad, n_parts=n_parts)
        m = len(p)
        pos[i, :m], curve_id[i, :m], part_labels[i, :m] = p, c, y
        valid[i, :m] = True
        categories[i] = cat
    return pos, curve_id, valid, part_labels, categories
