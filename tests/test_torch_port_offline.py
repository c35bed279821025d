"""The port's offline scanning simulator against the JAX package's on the
CPU, on the same seeded NumPy inputs:

* the rasterizer: ``rasterize_plain`` (K11's plain version) equal bit for
  bit to the JAX package's native C++ z-buffer
  (``rasterize(use_native=True)``) on the sphere, box and cylinder from
  several cameras, on an OBJ the test writes, on a face with a vertex at
  z = 2e-6 (its projection leaves the int range: x86-64 converts it to
  INT_MIN, which empties the face's box), on duplicated faces (the tie
  goes to the lower index), out-of-range indices and a degenerate face;
  the (z, face) key's order; ``rasterize`` on the CPU counts no launch
  and raises for a card that is missing;
* scan lines: equal ``uv`` and ``curve_id`` for equal seeds and masks, in
  every pattern; ``split_curves_3d`` and ``find_intersections`` equal;
* ``anti_alias`` within 1e-6 of JAX's; curvature and feature gradients
  within 1e-4 relative, with JAX's own circle and linear-ramp checks;
* the generator: ``generate_dataset(device="cpu")`` against JAX's at res
  96, 256 points, seed 0, 3 samples (the shapenet-seg and kortx
  settings): ``curve_id``, ``valid`` and ``category`` equal, ``pos``
  within 1e-6 (equal, as it is), labels equal; ``mesh_to_curve_cloud``
  with its
  curvature; the CLI;
* the ShapeNetCore layout: split filtering, label transfer, the real-label
  generator path against JAX's and the empty tree.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvecloudnet_tpu.simulator import curve_cloud as JC
from curvecloudnet_tpu.simulator import generate as JG
from curvecloudnet_tpu.simulator import rasterizer as JR
from curvecloudnet_tpu.simulator import scanlines as JS
from curvecloudnet_tpu_torch.simulator import curve_cloud as TC
from curvecloudnet_tpu_torch.simulator import generate as TG
from curvecloudnet_tpu_torch.simulator import rasterizer as TR
from curvecloudnet_tpu_torch.simulator import scanlines as TS
from curvecloudnet_tpu_torch.simulator import shapenet_core as TSC
from curvecloudnet_tpu_torch.tools import generate_shapenet
from test_shapenet_core import _make_tree

torch.set_num_threads(1)


def _native(verts, faces, pin):
    return JR.rasterize(verts, faces, JR.Pinhole(**vars(pin)),
                        use_native=True)


def _assert_raster_equal(verts, faces, pin):
    want = _native(verts, faces, pin)
    got = [t.numpy() for t in TR.rasterize_plain(verts, faces, pin)]
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    return want


def _icosphere_obj(path):
    """A small OBJ with quads (fan-triangulated on load) and a bump."""
    rng = np.random.default_rng(4)
    lat, lon = np.meshgrid(np.linspace(0.2, np.pi - 0.2, 7),
                           np.linspace(0, 2 * np.pi, 9, endpoint=False),
                           indexing="ij")
    r = 0.4 + 0.05 * rng.random(lat.shape)
    verts = np.stack([r * np.sin(lat) * np.cos(lon), r * np.cos(lat),
                      r * np.sin(lat) * np.sin(lon)], -1).reshape(-1, 3)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for i in range(6):
            for j in range(9):
                a, b = i * 9 + j, i * 9 + (j + 1) % 9
                f.write(f"f {a + 1}/1 {b + 1}/1 {b + 10}/1 {a + 10}/1\n")
    return path


MESHES = ["sphere", "box", "cylinder", "obj"]


@pytest.mark.parametrize("mesh", MESHES)
def test_rasterize_plain_matches_native(mesh, tmp_path):
    if mesh == "obj":
        verts, faces = TG.load_obj(_icosphere_obj(str(tmp_path / "m.obj")))
        jv, jf = JG.load_obj(str(tmp_path / "m.obj"))
        np.testing.assert_array_equal(verts, jv)
        np.testing.assert_array_equal(faces, jf)
    else:
        verts, faces = TG.PRIMITIVES[mesh]()
    res = 128
    pin = TR.Pinhole(res * 1.8, res * 1.8, res / 2, res / 2, res, res)
    covered = 0
    for dist, elev, azim in [(2.2, 20.0, 30.0), (2.0, -25.0, 200.0),
                             (1.4, 44.0, 311.0)]:
        cam = TR.look_at_camera(verts, distance=dist, elev_deg=elev,
                                azim_deg=azim)
        np.testing.assert_array_equal(
            cam, JR.look_at_camera(verts, distance=dist, elev_deg=elev,
                                   azim_deg=azim))
        covered += int(_assert_raster_equal(cam, faces, pin)[2].sum())
    assert covered > 1000


def test_rasterize_plain_edge_faces():
    """A vertex at z = 2e-6 past the int range, duplicated and reversed
    faces, an index past the vertices, a degenerate and a behind-camera
    face; a small chunk so the candidates reduce in several chunks."""
    v = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0],
                  [50.0, 0.0, 2e-6], [0.5, 0.5, 0.0], [2.0, 2.0, 1.0],
                  [-0.2, 0.3, 1.5], [0.8, -0.3, 0.7], [0.3, 0.9, 1.1]],
                 np.float32)
    f = np.array([[0, 1, 3], [0, 1, 2], [2, 1, 0], [0, 1, 2], [0, 1, 9],
                  [0, 5, 0], [0, 1, 4], [6, 7, 8], [8, 7, 6], [1, 2, 0]],
                 np.int32)
    pin = TR.Pinhole(100.0, 100.0, 64.0, 64.0, 128, 128)
    t, keep = TR._face_table(torch.as_tensor(v), torch.as_tensor(f), pin)
    # the far projection gives INT_MIN (x86), not a saturated INT_MAX
    assert int(t["x1"][0]) == -(2 ** 31) and not bool(keep[0])
    assert keep.tolist() == [False, True, True, True, False, False, False,
                             True, True, True]
    want = _assert_raster_equal(v, f, pin)
    assert want[2].sum() > 3000
    chunk = TR.CHUNK
    try:
        TR.CHUNK = 500
        got = TR.rasterize_plain(v, f, pin)
    finally:
        TR.CHUNK = chunk
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def _tiled(verts, faces, pin):
    """K11's tile pass on the CPU: each TR.TILE tile keys its pixels from
    the faces its list holds (``TR.tile_lists``, the kernel's two-level
    cull), a face's candidates over its box clipped to the tile; the keys
    resolved as the plain version resolves them."""
    v = torch.as_tensor(verts, dtype=torch.float32)
    f = torch.as_tensor(faces).to(torch.int32).reshape(-1, 3)
    t, keep = TR._face_table(v, f, pin)
    boxes = TR.face_boxes(t, keep)
    keys = torch.full((pin.h * pin.w,), TR._EMPTY, dtype=torch.int64)
    lists = TR.tile_lists(boxes, pin)
    for (tx, ty), fl in lists.items():
        tx0, ty0 = tx * TR.TILE, ty * TR.TILE
        tx1 = min(tx0 + TR.TILE, pin.w) - 1
        ty1 = min(ty0 + TR.TILE, pin.h) - 1
        b = boxes[fl]
        x0, x1 = b[:, 0].clamp(min=tx0), b[:, 1].clamp(max=tx1)
        y0, y1 = b[:, 2].clamp(min=ty0), b[:, 3].clamp(max=ty1)
        bw = x1 - x0 + 1
        cnt = bw * (y1 - y0 + 1)
        assert bool((cnt > 0).all())   # a listed face meets its tile
        local = torch.repeat_interleave(torch.arange(len(fl)), cnt)
        off = torch.arange(int(cnt.sum())) - (torch.cumsum(cnt, 0)
                                              - cnt)[local]
        fi = fl[local]
        x = x0[local] + off % bw[local]
        y = y0[local] + off // bw[local]
        l0, l1, l2, z, _ = TR._bary_depth(t, fi, x, y)
        m = TR._f32(-1e-6)
        hit = (~((l0 < m) | (l1 < m) | (l2 < m))
               & (z < float("inf"))).nonzero()[:, 0]
        keys.scatter_reduce_(0, (y * pin.w + x)[hit],
                             TR._keys_of(z[hit], fi[hit]), reduce="amin",
                             include_self=True)
    return TR.resolve_keys(t, keys, pin.h, pin.w), lists, boxes


def _assert_tiled_equal(verts, faces, pin):
    (coords, normals, mask), lists, boxes = _tiled(verts, faces, pin)
    want = _native(verts, faces, pin)
    np.testing.assert_array_equal(mask.numpy(), want[2])
    for g, w in zip((coords, normals), want[:2]):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      w.view(np.int32))
    # every face is listed by exactly the tiles its box meets
    n_tx, n_ty = -(-pin.w // TR.TILE), -(-pin.h // TR.TILE)
    assert sorted(lists) == [(x, y) for x in range(n_tx) for y in range(n_ty)]
    for (tx, ty), fl in lists.items():
        tx0, ty0 = tx * TR.TILE, ty * TR.TILE
        meet = TR._meets(boxes, tx0, min(tx0 + TR.TILE, pin.w) - 1, ty0,
                         min(ty0 + TR.TILE, pin.h) - 1).nonzero()[:, 0]
        assert torch.equal(fl, meet)
    return want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("res", [100, 130])
def test_rasterize_tiles_match_native(mesh, res, tmp_path):
    """K11's tile culling and tile-by-tile depth test (a resolution that is
    no multiple of the tile) equal the native z-buffer bit for bit."""
    if mesh == "obj":
        verts, faces = TG.load_obj(_icosphere_obj(str(tmp_path / "m.obj")))
    else:
        verts, faces = TG.PRIMITIVES[mesh]()
    pin = TR.Pinhole(res * 1.8, res * 1.8, res / 2, res / 2, res, res)
    covered = 0
    for dist, elev, azim in [(2.2, 20.0, 30.0), (1.4, 44.0, 311.0)]:
        cam = TR.look_at_camera(verts, distance=dist, elev_deg=elev,
                                azim_deg=azim)
        covered += int(_assert_tiled_equal(cam, faces, pin)[2].sum())
    assert covered > 1000


def test_rasterize_tiles_edge_faces():
    """The edge faces of ``test_rasterize_plain_edge_faces`` through the
    tiles, and duplicated faces spread over several chunk boxes (the tie
    goes to the lower index in every tile)."""
    v = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0],
                  [50.0, 0.0, 2e-6], [0.5, 0.5, 0.0], [2.0, 2.0, 1.0],
                  [-0.2, 0.3, 1.5], [0.8, -0.3, 0.7], [0.3, 0.9, 1.1]],
                 np.float32)
    f = np.array([[0, 1, 3], [0, 1, 2], [2, 1, 0], [0, 1, 2], [0, 1, 9],
                  [0, 5, 0], [0, 1, 4], [6, 7, 8], [8, 7, 6], [1, 2, 0]],
                 np.int32)
    pin = TR.Pinhole(100.0, 100.0, 64.0, 64.0, 130, 130)
    assert _assert_tiled_equal(v, f, pin)[2].sum() > 3000
    dup = np.concatenate([f, np.tile(f[[1, 7]], (40, 1)), f[::-1]])
    assert len(dup) > 3 * TR.CHUNK_FACES
    assert _assert_tiled_equal(v, dup, pin)[2].sum() > 3000


def test_raster_tiles_match_the_source():
    """The plain model's tile, chunk and table sizes are K11's
    (``csrc/rasterize.cu``)."""
    import re
    src = open(os.path.join(os.path.dirname(TR.__file__), os.pardir, "csrc",
                            "rasterize.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert TR.TILE == const("TILE")
    assert TR.CHUNK_FACES == const("CHUNK")
    assert f"sizeof(Face) == {TR.FACE_BYTES // 4} * 4" in src
    assert TR.table_bytes(33) == 33 * 88 + 8 + 33 * 16 + 2 * 16


def test_rasterize_key_order():
    z = torch.tensor([-np.inf, -3.0, -1e-30, -0.0, 0.0, 1e-30, 2.0, 3.4e38],
                     dtype=torch.float32)
    keys = TR._keys_of(z, torch.zeros(len(z), dtype=torch.int64))
    assert keys[3] == keys[4]           # -0 ties +0, as '<' has it
    assert bool((keys[1:] >= keys[:-1]).all())
    assert bool((torch.diff(keys)[[0, 1, 2, 4, 5, 6]] > 0).all())
    face = TR._keys_of(torch.tensor([2.0, 2.0]), torch.tensor([7, 3]))
    assert face[1] < face[0] and int(face[0]) & 0xFFFFFFFF == 7


def test_rasterize_dispatch(monkeypatch):
    verts, faces = TG.box()
    cam = TR.look_at_camera(verts)
    pin = TR.Pinhole(60.0, 60.0, 16.0, 16.0, 32, 32)
    TR.rasterize.launches = 0
    got = TR.rasterize(cam, faces, pin, device="cpu")
    want = TR.rasterize_plain(cam, faces, pin)
    assert TR.rasterize.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.rasterize(cam, faces, pin)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.generate_dataset("unused", n_samples=1)


@pytest.fixture(scope="module")
def sphere_mask():
    verts, faces = TG.uv_sphere(24, 32)
    cam = TR.look_at_camera(verts, distance=2.0)
    pin = TR.Pinhole(192.0, 192.0, 64.0, 64.0, 128, 128)
    return TR.rasterize_plain(cam, faces, pin)[2].numpy()


@pytest.mark.parametrize("pattern", ["random", "parallel", "grid"])
def test_scan_lines_match_jax(pattern, sphere_mask):
    got = TS.generate_scan_lines(np.random.default_rng(3), sphere_mask, 250,
                                 pattern=pattern, density=0.5)
    want = JS.generate_scan_lines(np.random.default_rng(3), sphere_mask, 250,
                                  pattern=pattern, density=0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert TS.generate_scan_lines(np.random.default_rng(0),
                                  np.zeros((16, 16), bool), 10) is None


def _curves(seed, n=300, n_curves=6):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.005, 0.02, n))
    pos = np.stack([np.cos(3 * t), np.sin(2 * t), t], -1)
    pos += 0.002 * rng.normal(size=pos.shape)
    cid = np.sort(rng.integers(0, n_curves, n)).astype(np.int32)
    return pos.astype(np.float32), cid


def test_split_and_intersections_match_jax():
    pos, cid = _curves(0)
    pos[100:] += 0.05 * (np.arange(200) // 40)[:, None]   # gaps to split at
    got = TC.split_curves_3d(pos, cid)
    np.testing.assert_array_equal(got, JC.split_curves_3d(pos, cid))
    assert got.max() > cid.max()
    a = np.stack([np.linspace(-1, 1, 60), np.zeros(60), np.zeros(60)], -1)
    b = np.stack([np.zeros(60), np.linspace(-1, 1, 60), np.zeros(60)], -1)
    cross = np.concatenate([a, b, pos[:80]]).astype(np.float32)
    ccid = np.concatenate([np.zeros(60), np.ones(60), 2 + cid[:80]])
    for thresh in (0.05, 0.2):
        got = TC.find_intersections(cross, ccid, thresh=thresh, block=50)
        want = JC.find_intersections(cross, ccid, thresh=thresh, block=50)
        np.testing.assert_array_equal(got, want)
        assert got.shape[1] >= 1


def _padded(seed, n_pad=320):
    """Two rows of curves with padding and a single-point curve."""
    pos = np.zeros((2, n_pad, 3), np.float32)
    cid = np.zeros((2, n_pad), np.int32)
    valid = np.zeros((2, n_pad), bool)
    for b, n in enumerate((300, 211)):
        p, c = _curves(seed + b, n)
        c[-1] = c[-2] + 1
        pos[b, :n], cid[b, :n], valid[b, :n] = p, c, True
    return pos, cid, valid


def test_anti_alias_matches_jax():
    pos, cid, valid = _padded(1)
    got = TC.anti_alias(torch.as_tensor(pos), torch.as_tensor(cid),
                        torch.as_tensor(valid)).numpy()
    want = np.asarray(JC.anti_alias(jnp.asarray(pos), jnp.asarray(cid),
                                    jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got - pos)[valid].max() > 1e-4   # it smooths
    assert (got[~valid] == 0).all()


# jitted: one compile where eager JAX compiles each of its ops
_jax_curvature = jax.jit(JC.estimate_curvature_and_grads)


def test_curvature_and_grads_match_jax():
    # one row (JAX's gathers vmap a (1, N, K) candidate table), with a
    # padded tail
    pos, cid, valid = (a[1:] for a in _padded(2, n_pad=300))
    feat = np.random.default_rng(5).normal(size=pos.shape[:2] + (2,))
    feat = feat.astype(np.float32)
    got = TC.estimate_curvature_and_grads(
        *(torch.as_tensor(a) for a in (pos, feat, cid, valid)))
    want = _jax_curvature(
        *(jnp.asarray(a) for a in (pos, feat, cid, valid)))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    pos2, cid2, valid2 = (torch.as_tensor(a) for a in _padded(2, n_pad=300))
    curv, grads = TC.estimate_curvature_and_grads(pos2, None, cid2, valid2)
    assert grads is None and curv.shape == pos2.shape


def test_curvature_of_circle_and_ramp():
    """JAX's own checks, on the port: a circle of radius r has curvature
    1/r toward its centre; df/ds of a linear ramp is its slope."""
    r, n = 2.0, 200
    ang = np.linspace(0, np.pi, n)
    pos = np.stack([r * np.cos(ang), r * np.sin(ang), np.zeros(n)],
                   -1).astype(np.float32)
    ones = torch.ones((1, n), dtype=torch.bool)
    zeros = torch.zeros((1, n), dtype=torch.int32)
    curv, _ = TC.estimate_curvature_and_grads(
        torch.as_tensor(pos)[None], None, zeros, ones, k=12)
    curv = curv[0].numpy()[20:n - 20]
    mag = np.linalg.norm(curv, axis=1)
    np.testing.assert_allclose(mag, 1.0 / r, rtol=0.05)
    np.testing.assert_allclose(curv / mag[:, None], -pos[20:n - 20] / r,
                               atol=0.05)
    n = 100
    pos = np.stack([np.linspace(0, 5, n), np.zeros(n), np.zeros(n)],
                   -1).astype(np.float32)
    feat = torch.as_tensor(3.0 * pos[:, :1])[None]
    _, grads = TC.estimate_curvature_and_grads(
        torch.as_tensor(pos)[None], feat, torch.zeros((1, n),
                                                      dtype=torch.int32),
        torch.ones((1, n), dtype=torch.bool), k=8)
    g = grads[0].numpy()[10:-10]
    np.testing.assert_allclose(np.abs(g[:, 0, 0]), 3.0, rtol=0.05)
    np.testing.assert_allclose(g[:, 0, 1:], 0.0, atol=1e-3)


def _check_shards(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    assert sorted(got.files) == sorted(want.files) == [
        "category", "curve_id", "labels", "pos", "valid"]
    for k in ("curve_id", "valid", "category"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=0, atol=1e-6)
    return got, want


GEN_CASES = {
    # configs/shapenet-seg.yaml:17's pattern and density, kortx's
    # (configs/kortx-testsplit.yaml:17) with a random SO(3) orientation
    "shapenet_seg": dict(pattern="grid", density=0.25),
    "kortx": dict(pattern="random", density=0.1666, random_so3=True),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_dataset_matches_jax(case, tmp_path):
    kw = dict(n_samples=3, n_points=256, resolution=96, seed=0,
              **GEN_CASES[case])
    want = JG.generate_dataset(str(tmp_path / "jax"), **kw)
    got = TG.generate_dataset(str(tmp_path / "port"), device="cpu", **kw)
    assert os.path.basename(got) == os.path.basename(want)
    g, w = _check_shards(got, want)
    np.testing.assert_array_equal(g["labels"], w["labels"])
    assert g["valid"].any(axis=1).all()
    # the CLI writes the same shard
    argv = ["--out", str(tmp_path / "cli"), "--n-samples", "3",
            "--n-points", "256", "--resolution", "96", "--pattern",
            kw["pattern"], "--density", str(kw["density"]), "--device",
            "cpu"]
    if case == "shapenet_seg":
        cli = generate_shapenet.main(argv)
        for k in g.files:
            np.testing.assert_array_equal(np.load(cli)[k], g[k])


def test_mesh_to_curve_cloud_with_curvature():
    verts, faces = TG.cylinder()
    vl = TG.part_labels_by_height(verts)
    np.testing.assert_array_equal(vl, JG.part_labels_by_height(verts))
    got = TG.mesh_to_curve_cloud(np.random.default_rng(7), verts, faces, vl,
                                 n_points=300, resolution=96,
                                 with_curvature=True, device="cpu")
    want = JG.mesh_to_curve_cloud(np.random.default_rng(7), verts, faces, vl,
                                  n_points=300, resolution=96)
    for k in ("curve_id", "labels", "normals"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("pos", "pos_obj"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    # JAX's with_curvature=True, i.e. its curvature of the smoothed scan
    curv, _ = _jax_curvature(
        jnp.asarray(want["pos"])[None], None,
        jnp.asarray(want["curve_id"])[None], jnp.ones((1, 300), bool))
    curv = np.asarray(curv[0])
    np.testing.assert_allclose(got["curvature"], curv, rtol=1e-4,
                               atol=1e-4 * np.abs(curv).max())


def test_shapenet_layout_matches_jax(tmp_path):
    """The split filtering, label transfer and empty-tree checks of
    tests/test_shapenet_core.py on the port, and the real-label generator
    path against JAX's."""
    core, csv_path, labels = _make_tree(str(tmp_path))
    train = TSC.ShapeNetCoreSplit(core, split="train",
                                  split_csv_path=csv_path, labels_dir=labels)
    val = TSC.ShapeNetCoreSplit(core, split="val", split_csv_path=csv_path)
    assert sorted(m.model_id for m in train) == ["m0", "m1"]
    assert [m.model_id for m in val] == ["m2"]
    assert len(TSC.ShapeNetCoreSplit(core)) == 3
    assert {m.synset for m in TSC.ShapeNetCoreSplit(
        core, synsets=["02691156"])} == {"02691156"}
    pts, seg = TSC.load_part_labels(train.models[0])
    assert pts.shape[1] == 3 and len(seg) == len(pts)

    rng = np.random.default_rng(0)
    label_pos = rng.normal(size=(500, 3)).astype(np.float32)
    lab = rng.integers(0, 5, 500)
    np.testing.assert_array_equal(
        TSC.transfer_part_labels(label_pos[::3] + 1e-5, label_pos, lab),
        lab[::3])

    kw = dict(n_samples=2, n_points=256, resolution=96, shapenet_dir=core,
              split="train", split_csv=csv_path, labels_dir=labels, seed=0)
    got = TG.generate_dataset(str(tmp_path / "port"), device="cpu", **kw)
    want = JG.generate_dataset(str(tmp_path / "jax"), **kw)
    g, w = _check_shards(got, want)
    np.testing.assert_array_equal(g["labels"], w["labels"])
    live = g["labels"][g["valid"]]
    assert set(np.unique(live)) <= {0, 1}
    assert 0.1 < float((live == 1).mean()) < 0.9

    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        TG.generate_dataset(str(tmp_path / "o"), n_samples=1, n_points=64,
                            shapenet_dir=str(tmp_path / "empty"),
                            device="cpu")
