"""The port's data layer against the JAX package's on the CPU, on files
that ``curvecloudnet_tpu_torch/tools/fake_datasets.py`` writes in each
dataset's own format (frames of a few hundred points):

* the readers (``SemKITTI``, ``SemNuScenes``, ``SemA2D2``,
  ``ObjectPthDataset``, ``KortxNpzDataset``): every ``Sample`` field and
  every ``meta`` entry (nuScenes' ``reorder`` too) ``np.array_equal`` to
  JAX's, without augmentation and with it from two equal
  ``np.random.default_rng(seed)`` draws (PolarMix in both branches, the
  lidar and object augmentations);
* curve extraction (``split_discontinuities``, ``extract_curves_beams``,
  ``partition_at_discontinuities``, ``extract_curves_knn``), ``polarmix``
  in each of its four branch pairs, and ``preprocess_kortx``'s shard, bit
  for bit;
* the nuScenes index routes: the info pkl (the test split kept without
  seg paths), the devkit (absent: it falls through), the glob (disjoint
  9:1 train / val, the warning for unpaired labels);
* ``main.load_datasets`` of every shipped config on a fixture directory:
  the same dataset classes with equal ``vars()``;
* a split of a real dataset that finds no frame raises, naming its glob.
"""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from curvecloudnet_tpu import main as jmain
from curvecloudnet_tpu.data import datasets as JD
from curvecloudnet_tpu.data import kortx as JK
from curvecloudnet_tpu.data import lidar as JL
from curvecloudnet_tpu_torch import config as tconfig
from curvecloudnet_tpu_torch import main as tmain
from curvecloudnet_tpu_torch.data import datasets as TD
from curvecloudnet_tpu_torch.data import kortx as TK
from curvecloudnet_tpu_torch.data import lidar as TL
from curvecloudnet_tpu_torch.tools import fake_datasets as F

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("nuscenes", "kitti", "audi", "shapenet-seg", "shapenet-class",
           "kortx-testsplit")
POINTS = (300, 700)     # points a lidar frame
OBJECT_POINTS = 128
SEEDS = range(6)        # augmentation draws a sample


def _config(name):
    return tconfig.load_config(os.path.join(REPO, "configs", f"{name}.yaml"))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{dataset: root} of small fixture files, written once a module."""
    base = tmp_path_factory.mktemp("data")
    out = {
        "kitti": F.write_kitti(str(base / "kitti"),
                               {"00": 3, "08": 2, "11": 2}, POINTS, 0),
        "nuscenes": F.write_nuscenes(str(base / "nuscenes"),
                                     {"train": 3, "val": 2, "test": 2},
                                     POINTS, 1),
        "audi": F.write_a2d2(str(base / "a2d2"), {"train": 3, "val": 2},
                             (400, 900), 2),
        "kortx_raw": F.write_kortx_raw(str(base / "kortx_raw"), 3, 300, 4),
    }
    for name in ("shapenet-seg", "shapenet-class", "kortx-testsplit"):
        cfg = _config(name)
        out[name] = F.write_objects(str(base / name),
                                    cfg["data_generation"],
                                    {"train": 4, "val": 2}, OBJECT_POINTS, 3)
    return out


def assert_same_sample(got, want):
    for f in ("pos", "curve_id", "feat", "labels", "category"):
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        assert np.asarray(g).dtype == np.asarray(w).dtype, f
        assert np.array_equal(g, w), f
    assert (got.meta is None) == (want.meta is None)
    if want.meta is not None:
        assert got.meta.keys() == want.meta.keys()
        for k, v in want.meta.items():
            assert np.array_equal(got.meta[k], v), k


def assert_same_reads(port_ds, jax_ds):
    """Every sample, plain and augmented from equal draws."""
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        assert_same_sample(port_ds.get(i), jax_ds.get(i))
        for seed in SEEDS:
            assert_same_sample(
                port_ds.get(i, np.random.default_rng(seed), True),
                jax_ds.get(i, np.random.default_rng(seed), True))


def assert_same_vars(got, want):
    g, w = vars(got), vars(want)
    assert g.keys() == w.keys()
    for k, v in w.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(g[k], v) and g[k].dtype == v.dtype, k
        else:
            assert g[k] == v, k


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

LIDAR = [("kitti", "SemKITTI", dict(n_pad=1024)),
         ("nuscenes", "SemNuScenes", dict(n_pad=1024)),
         ("audi", "SemA2D2", dict(n_pad=1024))]


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("source,cls,kw", LIDAR)
def test_lidar_readers_match_jax(roots, source, cls, kw, split):
    port_ds = getattr(TL, cls)(roots[source], split, **kw)
    jax_ds = getattr(JL, cls)(roots[source], split, **kw)
    assert_same_reads(port_ds, jax_ds)
    if source != "audi":
        # PolarMix grows a train sample past its frame at some draw
        grown = [len(port_ds.get(0, np.random.default_rng(s), True).pos)
                 for s in SEEDS]
        assert max(grown) > len(port_ds.get(0).pos)


def test_kitti_labels_and_meta(roots):
    """The upper 16 bits (instance ids) are masked off before the learning
    map; the meta names the frame for the submission writer."""
    ds = TL.SemKITTI(roots["kitti"], "val", 1024)
    raw = np.fromfile(ds.fpaths[0].replace("velodyne", "labels")[:-3]
                      + "label", np.uint32)
    assert (raw >> 16).any()
    s = ds.get(0)
    want = TL._map_labels((raw & 0xFFFF).astype(np.int64),
                          TL.KITTI_LEARNING_MAP)
    assert np.array_equal(s.labels, want) and s.labels.max() > 0
    assert s.meta == {"fpath": ds.fpaths[0], "format": "kitti"}
    assert s.meta["fpath"].split(os.sep)[-3] == "08"


@pytest.mark.parametrize("name,task", [("shapenet-seg", "segmentation"),
                                       ("shapenet-class", "classification")])
@pytest.mark.parametrize("use_curvature", [False, True])
def test_object_pth_matches_jax(roots, name, task, use_curvature):
    stem = TD.object_stem(_config(name)["data_generation"])
    for split in ("train", "val"):
        path = os.path.join(roots[name], f"{stem}_{split}.pth")
        kw = dict(n_pad=OBJECT_POINTS, task=task, n_classes=50,
                  use_curvature=use_curvature)
        port_ds, jax_ds = TD.ObjectPthDataset(path, **kw), \
            JD.ObjectPthDataset(path, **kw)
        assert_same_vars(port_ds, jax_ds)
        assert port_ds.in_dim == (6 if use_curvature else 3)
        assert_same_reads(port_ds, jax_ds)
        s = port_ds.get(1)
        assert s.curve_id.min() == 0
        np.testing.assert_allclose(np.linalg.norm(s.pos, axis=1).max(), 1.0,
                                   rtol=1e-6)


def test_kortx_matches_jax(roots, tmp_path):
    rng = np.random.default_rng(0)
    cid = np.cumsum(rng.random(200) < 0.3)
    pos = np.cumsum(rng.normal(0, 0.01, (200, 3)), axis=0)
    assert np.array_equal(TK.fix_curve_idxs(cid), JK.fix_curve_idxs(cid))
    assert np.array_equal(TK.cut_curves(cid, pos, 0.012),
                          JK.cut_curves(cid, pos, 0.012))
    kw = dict(n_points=256, samples_per_scan=3)
    got = TK.preprocess_kortx(roots["kortx_raw"], str(tmp_path / "port"),
                              **kw)
    want = JK.preprocess_kortx(roots["kortx_raw"], str(tmp_path / "jax"),
                               **kw)
    assert os.path.basename(got) == os.path.basename(want)
    with np.load(got) as g, np.load(want) as w:
        assert g.files == w.files
        for k in w.files:
            assert np.array_equal(g[k], w[k]) and g[k].dtype == w[k].dtype, k
        assert len(w["pos"]) == 3 * 2 * 3   # instances x views x windows
    for task, n_cls in (("segmentation", 50), ("classification", 16)):
        port_ds = TK.KortxNpzDataset(got, task, n_cls)
        jax_ds = JK.KortxNpzDataset(want, task, n_cls)
        assert_same_vars(port_ds, jax_ds)
        assert_same_reads(port_ds, jax_ds)


# ---------------------------------------------------------------------------
# curve extraction and PolarMix
# ---------------------------------------------------------------------------

def _scan(seed, n=500):
    rng = np.random.default_rng(seed)
    az = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(3, 40, n)
    pts = np.stack([r * np.cos(az), r * np.sin(az),
                    rng.normal(0, 1, n)], -1).astype(np.float32)
    return rng, pts


@pytest.mark.parametrize("seed", range(3))
def test_curve_extraction_matches_jax(seed):
    rng, pts = _scan(seed)
    extra = rng.random(len(pts) - 1) < 0.05
    for thresh in (0.08, 0.3):
        assert np.array_equal(TL.split_discontinuities(pts, thresh),
                              JL.split_discontinuities(pts, thresh))
        assert np.array_equal(
            TL.split_discontinuities(pts, thresh, extra),
            JL.split_discontinuities(pts, thresh, extra))
        assert np.array_equal(TL.extract_curves_sequential(pts, thresh),
                              JL.extract_curves_sequential(pts, thresh))
    beams = rng.integers(0, 32, len(pts))
    for got, want in zip(TL.extract_curves_beams(pts, beams),
                         JL.extract_curves_beams(pts, beams)):
        assert np.array_equal(got, want)
    reorder, inv, _ = TL.extract_curves_beams(pts, beams)
    assert np.array_equal(reorder[inv], np.arange(len(pts)))
    cid = np.sort(rng.integers(0, 20, len(pts)))
    assert np.array_equal(TL.partition_at_discontinuities(pts, cid, 0.1),
                          JL.partition_at_discontinuities(pts, cid, 0.1))
    ts = rng.permutation(len(pts))
    for k, thresh in ((4, 0.1), (3, 0.3)):
        for got, want in zip(TL.extract_curves_knn(pts, ts, k, thresh),
                             JL.extract_curves_knn(pts, ts, k, thresh)):
            assert np.array_equal(got, want)
    for n in (0, 1):
        for got, want in zip(TL.extract_curves_knn(pts[:n], ts[:n]),
                             JL.extract_curves_knn(pts[:n], ts[:n])):
            assert np.array_equal(got, want)


def test_polarmix_matches_jax_in_every_branch():
    """Seeds whose draws take each (sector swap, rotate-paste) pair."""
    _, p1 = _scan(10, 400)
    _, p2 = _scan(11, 300)
    rng = np.random.default_rng(12)
    y1, y2 = rng.integers(0, 20, 400), rng.integers(0, 20, 300)
    c1 = TL.extract_curves_sequential(p1)
    c2 = TL.extract_curves_sequential(p2) + c1.max() + 1
    pk1 = np.concatenate([p1, rng.random((400, 1)), c1[:, None]], 1)
    pk2 = np.concatenate([p2, rng.random((300, 1)), c2[:, None]], 1)
    seen = set()
    for seed in range(16):
        g = np.random.default_rng(seed)
        g.random()
        branches = (g.random() < 0.5, g.random() < 0.5)
        seen.add(branches)
        got = TL.polarmix(np.random.default_rng(seed), pk1, y1, pk2, y2,
                          TL.KITTI_INSTANCE_CLASSES)
        want = JL.polarmix(np.random.default_rng(seed), pk1, y1, pk2, y2,
                           JL.KITTI_INSTANCE_CLASSES)
        for a, b in zip(got, want):
            assert np.array_equal(a, b) and a.dtype == b.dtype
        cid = got[0][:, 4]
        assert (np.diff(cid) >= 0).all() and cid[0] == 0
        assert len(np.unique(cid)) == cid[-1] + 1   # dense ids
        if branches == (False, False):
            assert len(got[0]) == len(pk1)
    assert len(seen) == 4


# ---------------------------------------------------------------------------
# the nuScenes index routes
# ---------------------------------------------------------------------------

def _pairs(cls, root, split):
    return cls(root, split, 1024, False).pairs


def test_nuscenes_info_route_keeps_the_test_split(roots):
    for split, n in (("train", 3), ("val", 2), ("test", 2)):
        got = _pairs(TL.SemNuScenes, roots["nuscenes"], split)
        assert got == _pairs(JL.SemNuScenes, roots["nuscenes"], split)
        assert len(got) == n
        assert all((seg is None) == (split == "test") for _, seg, _ in got)
    ds = TL.SemNuScenes(roots["nuscenes"], "test", 1024)
    s = ds.get(1)
    assert s.meta["fname"] == f"{ds.pairs[1][2]}_lidarseg.bin"
    assert not s.labels.any()


def test_nuscenes_devkit_route_falls_through(roots, monkeypatch):
    """Without an info pkl the devkit is tried; absent (ImportError), the
    glob takes over in both packages."""
    root = roots["nuscenes"] + "_nopkl"
    shutil.copytree(roots["nuscenes"], root, dirs_exist_ok=True)
    for p in os.listdir(root):
        if p.endswith(".pkl"):
            os.remove(os.path.join(root, p))
    monkeypatch.setitem(sys.modules, "nuscenes", None)
    for split in ("train", "val"):
        assert _pairs(TL.SemNuScenes, root, split) == \
            _pairs(JL.SemNuScenes, root, split)


def test_nuscenes_glob_route(roots, tmp_path, capsys):
    """The glob pairs ``<stem>_lidarseg.bin`` files, warns for the frames
    it cannot pair (token-named files), and splits 9:1 by position."""
    root = str(tmp_path / "nusc")
    F.write_nuscenes(root, {"train": 11}, POINTS, 5)
    os.remove(os.path.join(root, "nuscenes_infos_train.pkl"))
    with open(os.path.join(roots["nuscenes"], "nuscenes_infos_train.pkl"),
              "rb") as f:
        assert "infos" in pickle.load(f)
    lid = sorted(os.listdir(os.path.join(root, "samples", "LIDAR_TOP")))
    seg_dir = os.path.join(root, "lidarseg", "v1.0-trainval")
    tok = sorted(os.listdir(seg_dir))[0]
    stem_named = lid[0].replace(".pcd.bin", "_lidarseg.bin")
    os.rename(os.path.join(seg_dir, tok), os.path.join(seg_dir, stem_named))
    out = {}
    for pkg, cls in (("port", TL.SemNuScenes), ("jax", JL.SemNuScenes)):
        out[pkg] = {s: _pairs(cls, root, s) for s in ("train", "val")}
        assert "could not pair lidarseg labels for 10/11" in \
            capsys.readouterr().out
    assert out["port"] == out["jax"]
    train = {p[0] for p in out["port"]["train"]}
    val = {p[0] for p in out["port"]["val"]}
    assert len(train) == 9 and len(val) == 2 and not train & val
    assert out["port"]["val"][0][1].endswith(stem_named)


# ---------------------------------------------------------------------------
# main.load_datasets and the empty split
# ---------------------------------------------------------------------------

def test_load_datasets_from_files_match_jax(roots):
    for name in CONFIGS:
        cfg = dict(_config(name), data_path=roots[name], n_pad=1024)
        want = jmain.load_datasets(cfg)
        got = tmain.load_datasets(cfg)
        for g, w in zip(got, want):
            assert type(g).__name__ == type(w).__name__ != \
                "SyntheticLidarSeg"
            assert type(g).__module__.startswith("curvecloudnet_tpu_torch")
            assert_same_vars(g, w)
        if name in ("nuscenes", "kitti"):
            assert got[0].polarmix_aug and not got[1].polarmix_aug
        if name == "shapenet-class":
            assert got[0].n_classes == 16 and got[0].task == "classification"
        assert_same_sample(got[0].get(0, np.random.default_rng(0), True),
                           want[0].get(0, np.random.default_rng(0), True))


@pytest.mark.parametrize("source,cls,glob_tail", [
    ("kitti", "SemKITTI", os.path.join("sequences", "{08}", "velodyne",
                                       "*.bin")),
    ("nuscenes", "SemNuScenes", os.path.join("samples", "LIDAR_TOP",
                                             "*.pcd.bin")),
    ("audi", "SemA2D2", os.path.join("val", "*.npz"))])
def test_empty_split_raises_naming_its_glob(tmp_path, source, cls,
                                            glob_tail):
    with pytest.raises(FileNotFoundError) as e:
        getattr(TL, cls)(str(tmp_path), "val", 1024)
    assert os.path.join(str(tmp_path), glob_tail) in str(e.value)
    # the shipped KITTI layout (data_path ending in sequences/) finds none
    if source == "kitti":
        os.makedirs(tmp_path / "sequences" / "08" / "velodyne")
        cfg = dict(_config("kitti"), data_path=str(tmp_path / "sequences"))
        with pytest.raises(FileNotFoundError, match="sequences"):
            tmain.load_datasets(cfg)
