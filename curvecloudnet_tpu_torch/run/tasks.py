"""Task registry and evaluation loops (counterpart of
``curvecloudnet_tpu/run/tasks.py``).

One generic eval loop serves every dataset; what differs per dataset
(ignore label, loss, TTA protocol, metric cropping) is declared in
``TASKS``.  The loops take the model with its weights (a module in eval
mode on its device) where the JAX loops take ``(model, variables)``.

Sampling draws: the JAX loops run every view with ``PRNGKey(0)``, which
torch cannot reproduce.  Here a loop's ``generator`` (None: the
deterministic ``key=None`` operating point) is reset to its starting
state before every forward, so each view draws the same numbers, as each
JAX view draws from the same key.

Host syncs: a loop waits for the device once a scan (a batch), on an
event recorded after that scan's work, with one scan in flight behind it;
telemetry, histograms and predictions stay on the device until then and
reach the host through pinned buffers copied without blocking.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.cloud import Cloud
from ..ops import telemetry
from ..train.trainer import LossConfig
from . import globals as G
from . import metrics as M

@dataclasses.dataclass
class TaskInfo:
    name: str
    task: str                      # "segmentation" | "classification"
    n_out: int
    loss_cfg: LossConfig             # without the class weights
    class_weights: Optional[np.ndarray] = None   # with use_ce_weights
    class_names: Optional[list] = None
    # eval protocol
    tta: bool = False              # 12-view flips x scales (nuscenes/kitti)
    metric_ignore: Optional[int] = 0
    part_iou: bool = False         # ShapeNet category-masked part IoU


TASKS: Dict[str, TaskInfo] = {
    "nuscenes": TaskInfo(
        name="nuscenes", task="segmentation", n_out=17,
        loss_cfg=LossConfig(ignore_index=0, use_lovasz=True,
                            lovasz_weight=1.0),
        class_names=G.NUSCENES_CLASSES, tta=True, metric_ignore=0),
    "kitti": TaskInfo(
        name="kitti", task="segmentation", n_out=20,
        loss_cfg=LossConfig(ignore_index=0, use_lovasz=True,
                            lovasz_weight=2.0, mean_over_all=True),
        class_weights=np.concatenate([[0.0], G.KITTI_CLASS_WEIGHTS]),
        class_names=G.KITTI_CLASSES, tta=True, metric_ignore=0),
    "audi": TaskInfo(
        name="audi", task="segmentation", n_out=13,
        loss_cfg=LossConfig(ignore_index=G.AUDI_IGNORE_LABEL,
                            use_lovasz=True),
        class_names=G.AUDI_CLASSES, tta=False,
        metric_ignore=G.AUDI_IGNORE_LABEL),
    "shapenet-seg": TaskInfo(
        name="shapenet-seg", task="segmentation",
        n_out=G.NUM_SHAPENET_SEG_CLASSES,
        loss_cfg=LossConfig(ignore_index=None),
        tta=False, metric_ignore=None, part_iou=True),
    "kortx": TaskInfo(
        name="kortx", task="segmentation",
        n_out=G.NUM_SHAPENET_SEG_CLASSES,
        loss_cfg=LossConfig(ignore_index=None),
        tta=False, metric_ignore=None, part_iou=True),
    "shapenet-class": TaskInfo(
        name="shapenet-class", task="classification", n_out=16,
        loss_cfg=LossConfig(task="classification"),
        class_names=G.SHAPENET_CATEGORY_NAMES, metric_ignore=None),
}


def loss_for(cfg: dict) -> LossConfig:
    """The loss a config trains with, as the JAX entry picks it: its task's
    (``task_for``), ``use_lovasz_loss`` overriding the Lovász switch
    (``dataclasses_replace_lovasz``), the task's class weights where
    ``use_ce_weights`` is set."""
    info = task_for(cfg.get("dataset_source", "nuscenes"),
                    cfg.get("task", "segmentation"))
    changes = {}
    if "use_lovasz_loss" in cfg:
        changes["use_lovasz"] = bool(cfg["use_lovasz_loss"])
    if cfg.get("use_ce_weights") and info.class_weights is not None:
        changes["class_weights"] = tuple(float(w) for w in
                                         info.class_weights)
    return dataclasses.replace(info.loss_cfg, **changes)


def task_for(dataset_source: str, task: str) -> TaskInfo:
    """The reference's ``select_task`` (run_utils.py:15-43)."""
    if (dataset_source in ("shapenet-seg", "shapenet")
            and task == "classification"):
        return TASKS["shapenet-class"]
    # the reference's Kortx test split loads SummerRoboticsDataset
    key = {"shapenet": "shapenet-seg",
           "summer-robotics": "kortx"}.get(dataset_source, dataset_source)
    if key.startswith("synthetic-lidar"):
        return TASKS["nuscenes"]
    if key.startswith("synthetic-object"):
        return dataclasses.replace(
            TASKS["shapenet-class"] if task == "classification"
            else TASKS["shapenet-seg"], part_iou=False)
    if key not in TASKS:
        raise KeyError(f"unknown dataset_source {dataset_source!r}")
    return TASKS[key]


# ---------------------------------------------------------------------------
# TTA forwards: 4 axis flips x 3 xy scales, averaged logits
# (reference nuscenes_seg.py:91-115 / kitti_seg.py:88-111)
# ---------------------------------------------------------------------------

TTA_FLIPS = np.array(
    [[1, 1], [-1, 1], [1, -1], [-1, -1]], np.float32)  # (4, 2)
TTA_SCALES = np.array([1.0, 0.95, 1.05], np.float32)
N_VIEWS = len(TTA_FLIPS) * len(TTA_SCALES)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _forward(model, cloud: Cloud, categories, generator, state):
    """One eval forward; the generator restarts from ``state`` (see the
    module docstring)."""
    if generator is not None:
        generator.set_state(state)
    if not model.spec.with_seg_category:
        categories = None
    return model(cloud, categories, generator=generator)


def _state(generator):
    return None if generator is None else generator.get_state()


def make_tta_eval(model, with_stats: bool = False,
                  generator: torch.Generator | None = None):
    """fn(cloud, flip (2,), scale (), categories=None) -> (logits,
    valid), plus the view's telemetry dict (device scalars) with
    ``with_stats``: one view of the cloud, its xy scaled by flip * scale."""
    state = _state(generator)

    @torch.inference_mode()
    def fwd(cloud: Cloud, flip, scale, categories=None):
        xy = cloud.pos[..., :2] * flip[None, None, :] * scale
        c = dataclasses.replace(
            cloud, pos=torch.cat([xy, cloud.pos[..., 2:]], dim=-1))
        if not with_stats:
            return _forward(model, c, categories, generator, state)
        with telemetry.capture() as cap:
            logits, out_valid = _forward(model, c, categories, generator,
                                         state)
            return logits, out_valid, cap.current()

    return fwd


def make_eval_post(n_cls: int, metric_ignore):
    """post(logits_list, labels, valid) -> (mean logits, confusion
    histogram delta): the views summed in list order, then divided."""

    @torch.inference_mode()
    def post(logits_list, labels, out_valid):
        mean_logits = sum(logits_list[1:], logits_list[0]) / len(logits_list)
        pred = torch.argmax(mean_logits, dim=-1)
        lv = out_valid
        if metric_ignore is not None:
            lv = lv & (labels != metric_ignore)
        return mean_logits, M.masked_hist(pred, labels, lv, n_cls)

    return post


def tta_views() -> np.ndarray:
    """(12, 2, 2) view parameters [flip, scale] per xy axis, flips outer,
    scales inner (the order of the per-view loop)."""
    return np.stack(
        [np.array([[f[0], f[1]] for f in TTA_FLIPS for _ in TTA_SCALES],
                  np.float32),
         np.array([[s, s] for _ in TTA_FLIPS for s in TTA_SCALES],
                  np.float32)], axis=-1)


def view_batch(cloud: Cloud, fs) -> Cloud:
    """The views ``fs`` (v, 2, 2) (rows of :func:`tta_views`) of a B=1
    cloud as one (v, N) batch."""
    v, n = fs.shape[0], cloud.pos.shape[1]
    xy = cloud.pos[..., :2] * fs[:, None, :, 0] * fs[:, None, :, 1]
    rep = lambda a: (None if a is None else  # noqa: E731
                     a[:1].expand((v,) + a.shape[1:]).contiguous())
    return dataclasses.replace(
        cloud, x=rep(cloud.x), valid=rep(cloud.valid),
        curve_id=rep(cloud.curve_id),
        pos=torch.cat([xy, cloud.pos[:1, :, 2:].expand(v, n, 1)], dim=-1))


def make_batched_tta_eval(model, views_per_call: int = 4, n_cls=None,
                          metric_ignore=None,
                          generator: torch.Generator | None = None):
    """The 12 TTA views of a (B=1) cloud as view-batched forwards.

    Chunks of ``views_per_call`` views run as one (v, N) batch each; each
    chunk's logits are summed over its views on the device, the chunk sums
    added in chunk order, and the total divided by 12.  Returns
    fn(cloud, labels=None) -> (mean_logits (1, N, C), valid (1, N), the
    last chunk's telemetry dict); with ``n_cls`` set, the argmax and the
    confusion-histogram delta of the mean (one more output) follow the
    last chunk, as the JAX function folds them into its last dispatch."""
    v = views_per_call
    if N_VIEWS % v:
        raise ValueError(f"views_per_call {v} does not divide {N_VIEWS}")
    all_fs = tta_views()
    state = _state(generator)
    staged = {}

    def _fs(s, device):
        if (s, device) not in staged:
            staged[(s, device)] = torch.from_numpy(all_fs[s:s + v]).to(device)
        return staged[(s, device)]

    def _chunk(cloud: Cloud, fs, with_stats: bool):
        c = view_batch(cloud, fs)
        stats = {}
        if with_stats:
            with telemetry.capture() as cap:
                logits, out_valid = _forward(model, c, None, generator, state)
                stats = cap.current()
        else:
            logits, out_valid = _forward(model, c, None, generator, state)
        return logits.sum(dim=0, keepdim=True), out_valid[:1], stats

    @torch.inference_mode()
    def fwd(cloud: Cloud, labels=None):
        total = None
        for s in range(0, N_VIEWS, v):
            last = s + v >= N_VIEWS
            part, out_valid, stats = _chunk(cloud, _fs(s, cloud.pos.device),
                                            with_stats=last)
            total = part if total is None else total + part
        mean_logits = total / float(N_VIEWS)
        if n_cls is None:
            return mean_logits, out_valid, stats
        pred = torch.argmax(mean_logits, dim=-1)
        lv = out_valid
        if metric_ignore is not None:
            lv = lv & (labels != metric_ignore)
        return (mean_logits, out_valid, stats,
                M.masked_hist(pred, labels, lv, n_cls))

    return fwd


def dump_submission(mean_logits, valid, metas, outdir: str):
    """Write test-split predictions in the dataset's own format
    (reference nuscenes_seg.py:131-140, kitti_seg.py:127-135)."""
    for k, meta in enumerate(metas):
        if meta is None:
            continue
        v = M._host(valid[k])
        if meta.get("format") == "nuscenes":
            # class 0 ('noise') is never predicted: argmax over 1..C-1, +1
            lg = M._host(mean_logits[k])[v][:, 1:]
            pred = (np.argmax(lg, axis=-1) + 1).astype(np.uint8)
            reorder = meta["reorder"][: len(pred)]
            pred = pred[reorder]
            folder = os.path.join(outdir, "results", "lidarseg", "test")
            os.makedirs(folder, exist_ok=True)
            pred.tofile(os.path.join(folder, meta["fname"]))
        elif meta.get("format") == "kitti":
            lg = M._host(mean_logits[k])[v]
            pred = np.argmax(lg, axis=-1)
            lut = np.zeros(max(G.KITTI_LEARNING_MAP_INV) + 1, np.uint32)
            for a, b in G.KITTI_LEARNING_MAP_INV.items():
                lut[a] = b
            raw = lut[pred].astype(np.uint32)
            parts = meta["fpath"].split(os.sep)
            seq, fname = parts[-3], parts[-1][:-4] + ".label"
            folder = os.path.join(outdir, "method_predictions", "sequences",
                                  seq, "predictions")
            os.makedirs(folder, exist_ok=True)
            raw.tofile(os.path.join(folder, fname))


def stage(device: torch.device, *tensors):
    """Start the copies of device tensors to the host -> (host tensors,
    the event after them, or None on the CPU): fresh pinned buffers,
    copied without blocking, read after :func:`wait`."""
    if device.type != "cuda":
        return list(tensors), None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return host, event


def wait(event) -> None:
    """Block until the copies :func:`stage` started are done."""
    if event is not None:
        event.synchronize()


def _loader(dataset, batch_size):
    from ..data.loader import PrefetchLoader

    # worker-prepared batches overlap host-side sample preparation with
    # device compute
    return PrefetchLoader(dataset, batch_size, shuffle=False, drop_last=False,
                          num_workers=2, prefetch=2, shard_by_process=False)


def _pack(stats: dict):
    """Telemetry dict -> (keys, one float32 vector) for one copy."""
    keys = tuple(stats)
    if not keys:
        return keys, None
    return keys, torch.stack([torch.as_tensor(stats[k]).float().reshape(())
                              for k in keys])


def evaluate_segmentation(model, dataset, task_info: TaskInfo,
                          batch_size: int = 1, max_batches: int | None = None,
                          use_tta: bool | None = None, log: Callable = print,
                          test_mode: bool = False, outdir: str | None = None,
                          batched_tta: bool | None = None,
                          tta_views_per_call: int = 2,
                          generator: torch.Generator | None = None):
    """Segmentation eval: (m)IoU, throughput, peak memory and the overflow
    telemetry (plus submission files with ``test_mode``).

    Returns dict(miou, per_class_iou, class_names, mean_forward_s,
    points_per_sec, peak_device_memory_gb, overflow) as the JAX loop
    does, and ``scan_wall_s``, the TTA scan wall: ``mean_forward_s`` x
    views over the scans after the warm-up (nan with one scan).  The
    warm-up scan drains at once, so the completion-to-completion spans
    after it add up to the wall from its drain to the last drain, loader
    and drains included."""
    from ..data.datasets import to_device_batch

    device = _device_of(model)
    use_tta = task_info.tta if use_tta is None else use_tta
    n_cls = task_info.n_out
    if batched_tta is None:
        # view-batched chunks on the card, the per-view path on the CPU,
        # as the JAX loop decides by backend
        batched_tta = device.type == "cuda"
    use_batched = use_tta and batched_tta and batch_size == 1
    fwd = (make_batched_tta_eval(model, tta_views_per_call, n_cls=n_cls,
                                 metric_ignore=task_info.metric_ignore,
                                 generator=generator)
           if use_batched else make_tta_eval(model, with_stats=True,
                                             generator=generator))
    post = make_eval_post(n_cls, task_info.metric_ignore)
    hist = torch.zeros((n_cls, n_cls), dtype=torch.int64, device=device)
    times, n_pts = [], 0
    stats_acc: Dict[str, list] = {}
    pad_dropped = 0
    views = ([(f, s) for f in TTA_FLIPS for s in TTA_SCALES]
             if use_tta else [(TTA_FLIPS[0], TTA_SCALES[0])])
    n_views = len(views)
    views_dev = [(torch.from_numpy(f).to(device),
                  torch.tensor(s, device=device)) for f, s in views]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # one scan stays in flight while the next is prepared and queued; the
    # host waits once a scan, at the drain
    prev = None
    t_done = None

    def _drain(entry):
        nonlocal t_done, n_pts
        host, event, keys, metas, nv, t0 = entry
        wait(event)
        now = time.time()
        # steady state: completion-to-completion interval per scan
        span = now - (t_done if t_done is not None else t0)
        t_done = now
        times.extend([span / n_views] * n_views)
        if keys:
            for sk, sv in zip(keys, host[0].tolist()):
                stats_acc.setdefault(sk, []).append(float(sv))
        n_pts += nv
        if test_mode and outdir is not None:
            dump_submission(host[-2], host[-1], metas, outdir)

    loader = _loader(dataset, batch_size)
    for bi, np_batch in enumerate(loader.epoch(0)):
        if max_batches is not None and bi >= max_batches:
            break
        metas = np_batch.pop("_meta", [None] * len(np_batch["pos"]))
        pad_dropped += int(np.sum(np_batch.pop("n_pad_dropped", 0)))
        nv = int(np_batch["valid"].sum())
        batch = to_device_batch(np_batch, task_info.task, device)
        t0 = time.time()
        if use_batched:
            mean_logits, out_valid, stats, hist_delta = fwd(batch.cloud,
                                                            batch.labels)
        else:
            # every view queued without an intermediate wait
            all_logits, stats = [], None
            for f, s in views_dev:
                logits, out_valid, stats = fwd(batch.cloud, f, s,
                                               batch.categories)
                all_logits.append(logits)
            mean_logits, hist_delta = post(all_logits, batch.labels,
                                           out_valid)
        hist += hist_delta
        keys, vec = _pack(stats)
        out = ([vec] if keys else []) + (
            [mean_logits, batch.cloud.valid] if test_mode else [])
        host, event = stage(device, *out)
        if prev is not None:
            _drain(prev)
        prev = (host, event, keys, metas, nv, t0)
        if bi == 0:
            # the warm-up scan (first-call setup) drains at once: the
            # window timed after it starts with nothing in flight
            _drain(prev)
            prev = None
    if prev is not None:
        _drain(prev)

    hist = hist.cpu().numpy()
    if task_info.metric_ignore is not None:
        keep = [c for c in range(n_cls) if c != task_info.metric_ignore]
        hist = hist[np.ix_(keep, keep)]
        names = ([task_info.class_names[c] for c in keep]
                 if task_info.class_names else None)
    else:
        names = task_info.class_names
    iou = M.per_class_iu(hist)
    # skip the warm-up scan (first-call setup, kernel builds) as the
    # reference skips warm-up iterations (nuscenes_seg.py:148)
    skip = len(views) if len(times) > len(views) else min(
        5, max(0, len(times) - 1))
    warm = times[skip:]
    mean_fwd = float(np.mean(warm)) if warm else float("nan")
    pts_per_fwd = (n_pts * len(views)) / max(len(times), 1)
    points_per_sec = (pts_per_fwd / mean_fwd if warm and mean_fwd > 0
                      else float("nan"))
    # the reference logs torch.cuda.max_memory_allocated per val loop
    # (nuscenes_seg.py:111,149); the peak is reset at the loop's start
    peak_gb = (torch.cuda.max_memory_allocated(device) / 1e9
               if device.type == "cuda" else float("nan"))
    overflow = {k: float(np.mean(v)) for k, v in stats_acc.items()}
    overflow["n_pad_dropped_points"] = pad_dropped
    result = {
        "miou": float(np.nanmean(iou)),
        "per_class_iou": iou.tolist(),
        "class_names": names,
        "mean_forward_s": mean_fwd,
        "points_per_sec": points_per_sec,
        "peak_device_memory_gb": peak_gb,
        "overflow": overflow,
        "scan_wall_s": (mean_fwd * n_views if len(times) > n_views
                        else float("nan")),
    }
    log(f"mIoU: {result['miou']:.4f}  "
        f"(fwd {mean_fwd*1e3:.1f} ms, {result['points_per_sec']:.0f} pts/s, "
        f"scan {result['scan_wall_s']*1e3:.1f} ms)")
    worst = {k: v for k, v in overflow.items()
             if ("overflow" in k or "truncated" in k or "dropped" in k)
             and v > 0}
    if worst:
        log(f"overflow telemetry (nonzero): {worst}")
    return result


def evaluate_part_segmentation(model, dataset, task_info: TaskInfo,
                               batch_size: int = 8,
                               max_batches: int | None = None,
                               log: Callable = print,
                               generator: torch.Generator | None = None):
    """ShapeNet-style category-masked part IoU (reference
    shapenet_seg.py:86-107), one batch in flight behind the one scored."""
    from ..data.datasets import to_device_batch

    device = _device_of(model)
    fwd = make_tta_eval(model, generator=generator)
    cat_parts = list(G.SHAPENET_SEG_CLASSES.values())
    per_cat: Dict[int, list] = {}
    inst_ious = []

    def consume(entry):
        (logits, valid, cats), event, labels = entry
        wait(event)
        logits, valid, cats = (t.numpy() for t in (logits, valid, cats))
        for k in range(len(cats)):
            if task_info.part_iou:
                parts = np.asarray(cat_parts[int(cats[k])])
                pred = parts[np.argmax(logits[k][:, parts], axis=-1)]
            else:
                parts = np.arange(task_info.n_out)
                pred = np.argmax(logits[k], axis=-1)
            iou = M.part_iou_shapenet(pred, labels[k], valid[k], parts)
            inst_ious.append(iou)
            per_cat.setdefault(int(cats[k]), []).append(iou)

    flip = torch.from_numpy(TTA_FLIPS[0]).to(device)
    scale = torch.tensor(TTA_SCALES[0], device=device)
    pending = None
    for bi, np_batch in enumerate(_loader(dataset, batch_size).epoch(0)):
        if max_batches is not None and bi >= max_batches:
            break
        labels = np.asarray(np_batch["labels"])
        batch = to_device_batch(np_batch, task_info.task, device)
        logits, out_valid = fwd(batch.cloud, flip, scale, batch.categories)
        staged = stage(device, logits, out_valid, batch.categories)
        if pending is not None:
            consume(pending)
        pending = (*staged, labels)
    if pending is not None:
        consume(pending)
    cat_miou = float(np.mean([np.mean(v) for v in per_cat.values()]))
    inst_miou = float(np.mean(inst_ious))
    log(f"instance mIoU: {inst_miou:.4f}  category mIoU: {cat_miou:.4f}")
    return {"instance_miou": inst_miou, "category_miou": cat_miou}


def evaluate_classification(model, dataset, task_info: TaskInfo,
                            batch_size: int = 16,
                            max_batches: int | None = None,
                            log: Callable = print, media_logger=None,
                            generator: torch.Generator | None = None):
    """Classification metrics (reference shapenet_classification.py:96-151),
    one batch in flight behind the one scored; with ``media_logger`` (a
    ``MetricLogger``) the row-normalized confusion figure is logged as
    ``eval/confusion`` where matplotlib is installed (a line says so where
    it is not)."""
    from ..data.datasets import to_device_batch

    device = _device_of(model)
    n_cls = task_info.n_out
    fwd = make_tta_eval(model, generator=generator)
    confmat = np.zeros((n_cls, n_cls), np.int64)
    flip = torch.from_numpy(TTA_FLIPS[0]).to(device)
    scale = torch.tensor(TTA_SCALES[0], device=device)
    pending = None

    def consume(entry):
        (pred,), event, labels = entry
        wait(event)
        for y, p in zip(labels, pred.numpy()):
            confmat[int(y), int(p)] += 1

    for bi, np_batch in enumerate(_loader(dataset, batch_size).epoch(0)):
        if max_batches is not None and bi >= max_batches:
            break
        labels = np.asarray(np_batch["labels"])
        batch = to_device_batch(np_batch, task_info.task, device)
        logits, _ = fwd(batch.cloud, flip, scale, batch.categories)
        staged = stage(device, torch.argmax(logits[:, 0, :], dim=-1))
        if pending is not None:
            consume(pending)
        pending = (*staged, labels)
    if pending is not None:
        consume(pending)
    acc, bal = M.confmat2acc(confmat)
    prec, rec, f1 = M.confmat2precrec(confmat)
    log(f"accuracy: {acc:.4f}  balanced: {bal:.4f}")
    if media_logger is not None:
        # the reference logs the figure as wandb media
        # (shapenet_classification.py:109)
        if importlib.util.find_spec("matplotlib") is None:
            log("confusion figure not drawn: matplotlib is not installed")
        else:
            from ..visualization import plot_confusion

            media_logger.log_media(
                "eval/confusion",
                plot_confusion(confmat, class_names=task_info.class_names,
                               path=None))
    return {"accuracy": acc, "balanced_accuracy": bal,
            "precision": prec.tolist(), "recall": rec.tolist(),
            "f1": f1.tolist(), "confmat": confmat.tolist()}
