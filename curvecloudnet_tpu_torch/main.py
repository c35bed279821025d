"""The config-driven train, eval and test entry point (counterpart of
``curvecloudnet_tpu/main.py``).

Usage, as the reference's (``src/main.py``)::

    python -m curvecloudnet_tpu_torch.main --config configs/nuscenes.yaml \\
        [--epochs=2] [--n_train=6] [--n_val=2] [--device=cpu] [--key=value ...]
    python -m curvecloudnet_tpu_torch.main --config configs/nuscenes.yaml \\
        --only_val=true [--n_val=2] [--device=cpu]

Without ``only_val`` / ``only_test`` it trains (:func:`train`, the JAX
entry's epoch loop): Adam on the config's schedule, the task's loss, the
BN momentum decayed per epoch, a validation every ``val_every`` epochs,
``best_epoch{E}`` / ``epoch{E}`` / ``latest`` checkpoints with the
optimizer state, resuming from ``outdir``'s ``latest``.  ``--only_val``
scores the val split (mIoU under 12-view TTA for the lidar datasets, part
mIoU or accuracy for the objects); ``--only_test`` also writes the
test-split submission files under ``outdir``.  The model is built at the
dataset's ``n_pad`` on ``device`` (default ``cuda``; there is no fallback
to the CPU), with random weights from ``seed``, the reference ``.pth`` at
``weights``, a native checkpoint at ``weights``, or the ``latest``
checkpoint of ``outdir``.  The datasets are read from ``data_path``
(:func:`load_datasets`: SemanticKITTI, nuScenes, A2D2 and the object
``.pth`` files, in the layouts ``data/lidar.py`` and
``data/datasets.py`` describe); where ``data_path`` does not exist they
are the JAX entry's synthetic stand-ins.

Data parallelism (``parallel``): launch one process a rank with the
same config but for the process id::

    CCN_PROCESS_ID=$i python -m curvecloudnet_tpu_torch.main \\
        --config configs/nuscenes.yaml --distributed.num_processes 2 \\
        --distributed.coordinator_address 127.0.0.1:29500

(``distributed.process_id`` in place of ``CCN_PROCESS_ID``), or set
``data_parallel_devices: n`` to spawn a process a visible GPU (with fewer
GPUs visible it runs one process).  Each process trains on its lockstep
shard of every epoch (the schedule counts its steps), the step is the
global batch's (``train.trainer.train_step``), every process runs the
validation over the whole val set, and process 0 writes the checkpoints,
``latest_state.json`` and ``metrics.jsonl``.  A process's device is
``cuda:{LOCAL_RANK or rank % device count}``; the backend ``nccl`` when
every process has a card of its own, else ``gloo``.

``--only_viz`` (:func:`run_viz`) draws figures of a few val samples
under ``outdir/viz`` and ``outdir/media`` (matplotlib is needed for the
figure files).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from . import checkpoint as ckpt
from . import parallel
from .config import DEFAULT_DEVICE, parse_args
from .data import datasets as D
from .logging_utils import MetricLogger
from .models import CurveCloudNet, parse_model_config
from .run import tasks as T
from .train.trainer import (bn_momentum_for_epoch, create_optimizer,
                            make_schedule, train_step)

LIDAR_SOURCES = ("nuscenes", "kitti", "audi")
OBJECT_SOURCES = ("shapenet-seg", "shapenet", "kortx")


def load_datasets(cfg):
    """(train, val) datasets of a config (the reference's
    load_utils.load_dataset:73-126): the lidar readers of ``data/lidar.py``
    on ``data_path``, the object ``.pth`` split files
    ``data_{num_points}_{resolution}_{line_density}_{laser_motion}_{split}
    .pth`` under it, or the synthetic stand-ins where ``data_path`` does not
    exist."""
    src = cfg["dataset_source"]
    if src == "summer-robotics":  # the reference's Kortx test split
        src = "kortx"
    task = cfg.get("task", "segmentation")
    data_path = cfg.get("data_path", "")
    n_pad = int(cfg.get("n_pad", 2048 if "shapenet" in src or "kortx" in src
                         or "object" in src else 32768))
    have_data = bool(data_path) and os.path.exists(data_path)

    if src.startswith("synthetic-lidar") or (
            src in LIDAR_SOURCES and not have_data):
        if not src.startswith("synthetic"):
            print(f"[data] {data_path!r} missing -> synthetic lidar stand-in")
        n_cls = T.task_for(src, task).n_out if src in T.TASKS else 17
        train = D.SyntheticLidarSeg(n_samples=cfg.get("n_train", 32),
                                    n_pad=n_pad, n_classes=n_cls, seed=1)
        val = D.SyntheticLidarSeg(n_samples=cfg.get("n_val", 8),
                                  n_pad=n_pad, n_classes=n_cls, seed=2)
        return train, val

    if src in LIDAR_SOURCES:
        from .data import lidar

        return lidar.load_lidar_datasets(cfg, n_pad)

    if src.startswith("synthetic-object") or (
            src in OBJECT_SOURCES and not have_data):
        if not src.startswith("synthetic"):
            print(f"[data] {data_path!r} missing -> synthetic objects "
                  "stand-in")
        train = D.SyntheticObjects(n_samples=cfg.get("n_train", 64),
                                   n_pad=n_pad, task=task, seed=1)
        val = D.SyntheticObjects(n_samples=cfg.get("n_val", 16),
                                 n_pad=n_pad, task=task, seed=2)
        return train, val

    if src in OBJECT_SOURCES:
        stem = D.object_stem(cfg.get("data_generation"))
        n_cls = (16 if task == "classification"
                 else T.task_for(src, task).n_out)
        use_curv = bool(cfg.get("use_curvature", False))
        return tuple(D.ObjectPthDataset(
            os.path.join(data_path, f"{stem}_{split}.pth"), n_pad=n_pad,
            task=task, n_classes=n_cls, use_curvature=use_curv)
            for split in ("train", "val"))

    raise KeyError(f"unknown dataset_source {src!r}")


def run_eval(model, val_ds, info, cfg, log=print, logger=None,
             generator: torch.Generator | None = None):
    """The task's eval loop on the val set.  Lidar scenes evaluate at
    batch 1 (reference main.py:32), objects in batches of 8.  ``logger``
    (a ``MetricLogger``) takes the classification loop's confusion
    figure."""
    with parallel.local():   # every process scores the whole set
        return _run_eval(model, val_ds, info, cfg, log, generator, logger)


def _run_eval(model, val_ds, info, cfg, log, generator, logger):
    lidar_scene = info.task == "segmentation" and not info.part_iou
    bs = int(cfg.get("eval_batch_size", 1 if lidar_scene else 8))
    max_b = cfg.get("eval_max_batches")
    if info.task == "classification":
        return T.evaluate_classification(model, val_ds, info, batch_size=bs,
                                         max_batches=max_b, log=log,
                                         media_logger=logger,
                                         generator=generator)
    if info.part_iou:
        return T.evaluate_part_segmentation(model, val_ds, info,
                                            batch_size=bs, max_batches=max_b,
                                            log=log, generator=generator)
    return T.evaluate_segmentation(
        model, val_ds, info, batch_size=bs, max_batches=max_b,
        use_tta=cfg.get("use_tta"), log=log,
        test_mode=_flag(cfg, "only_test"),
        outdir=cfg.get("outdir") if parallel.is_primary() else None,
        generator=generator)


VIZ_K = 8   # neighbors a point of the grouping-edge figure


def viz_samples(model, val_ds, info, cfg, n_samples: int = 4):
    """The arrays behind :func:`run_viz`'s figures, a dict a sample (host
    NumPy arrays).  The samples are the curated ``viz_idxs`` (the
    config's, else the dataset's, src/run/globals.py:9-14,52-60) that the
    val set holds, filled up with its first samples; each goes through
    the TTA view-0 forward on the model's device.  Keys: ``index``,
    ``pos``, ``curve_id``, ``valid`` (the forward's), ``pred`` (the
    argmax, per point or the sample's class), ``gt`` (per-point labels or
    None), ``cmap``, ``edges`` (the (N, ``VIZ_K``) ``same_set_knn`` table,
    -1 fill), ``tangents`` and ``along`` (unit next-on-curve deltas, and
    where a next point on the curve exists) and ``panels`` (the numpy
    splat render of prediction | ground truth for segmentation, else
    None)."""
    from .ops import neighbors
    from .run.globals import dataset_cmap, dataset_viz_idxs
    from .visualization import label_colormap, render_segmentation_panels

    device = next(model.parameters()).device
    preset = {"kitti": "kitti", "nuscenes": "kitti", "audi": "audi"}.get(
        info.name, "shapenet")
    curated = cfg.get("viz_idxs") or dataset_viz_idxs(info.name) or []
    idxs = [i for i in curated if i < len(val_ds)][:n_samples]
    if len(idxs) < n_samples:
        seen = set(idxs)
        idxs += [i for i in range(len(val_ds)) if i not in seen][
            : n_samples - len(idxs)]
    cm = dataset_cmap(info.name)
    if cm is None or len(cm) < info.n_out:
        cm = label_colormap(info.n_out)
    fwd = T.make_tta_eval(model)
    flip = torch.from_numpy(T.TTA_FLIPS[0]).to(device)
    scale = torch.tensor(T.TTA_SCALES[0], device=device)
    rng_v = np.random.default_rng(0)
    for idx in idxs:
        sample = D.pad_sample(val_ds.get(int(idx), rng=rng_v, augment=False),
                              val_ds.n_pad)
        np_batch = {k: v[None] for k, v in sample.items() if k != "_meta"}
        batch = D.to_device_batch(np_batch, info.task, device)
        logits, out_valid = fwd(batch.cloud, flip, scale, batch.categories)
        with torch.inference_mode():
            nbr, _ = neighbors.same_set_knn(batch.cloud.pos,
                                            batch.cloud.valid, VIZ_K)
        pred, valid, pos, cid, edges = (t[0].cpu().numpy() for t in (
            torch.argmax(logits, -1), out_valid, batch.cloud.pos,
            batch.cloud.curve_id, nbr))
        labels = np_batch["labels"]
        gt = labels[0] if np.ndim(labels) > 1 else None
        # curve directions (reference visualize_plotly.py:19-49,195-199):
        # the tangent is the next-on-curve delta
        tan = np.zeros_like(pos)
        tan[:-1] = pos[1:] - pos[:-1]
        along = np.zeros(len(pos), bool)
        along[:-1] = (cid[1:] == cid[:-1]) & valid[1:].astype(bool)
        tan = np.where(along[:, None], tan, 0.0)
        norm = np.linalg.norm(tan, axis=-1, keepdims=True)
        tan = np.divide(tan, norm, out=np.zeros_like(tan), where=norm > 0)
        panels = (render_segmentation_panels(pos, pred, gt, cm,
                                             preset=preset, valid=valid)
                  if info.task == "segmentation" and gt is not None
                  else None)
        yield dict(index=int(idx), pos=pos, curve_id=cid, valid=valid,
                   pred=pred, gt=gt, cmap=cm, edges=edges, tangents=tan,
                   along=along, panels=panels)


def run_viz(model, val_ds, info, cfg, outdir, n_samples: int = 4,
            logger: Optional[MetricLogger] = None) -> str:
    """Figures of a few val samples (the JAX entry's ``run_viz``; the
    reference's viz_seg paths, e.g. nuscenes_seg.py:168-226), from
    :func:`viz_samples`: per sample ``i`` the curve plot
    (``viz/curves_i.png``), the pred / GT scatter (``seg_i.png``, per-point
    tasks) with its plotly figure where plotly is installed, the
    grouping-edge graph (``edges_i.png``), the curve-tangent cones
    (``tangents_i.png``) and the rendered pred | GT panels (segmentation),
    each through ``logger.log_media`` (wandb where available, else
    ``outdir/media/``).  Needs matplotlib.  Returns the figure folder."""
    from .visualization import (grouping_edges_figure, plot_curve_cloud,
                                plot_segmentation, to_plotly_figure,
                                vector_cones_figure)

    if logger is None:
        logger = MetricLogger(outdir, use_wandb=_flag(cfg, "use_wandb"),
                              config=cfg)
    viz_dir = os.path.join(outdir, "viz")
    os.makedirs(viz_dir, exist_ok=True)
    for i, s in enumerate(viz_samples(model, val_ds, info, cfg, n_samples)):
        pos, valid = s["pos"], s["valid"]
        curves_png = os.path.join(viz_dir, f"curves_{i}.png")
        plot_curve_cloud(pos, s["curve_id"], valid, curves_png)
        logger.log_media(f"viz/curves_{i}", curves_png)
        if len(s["pred"]) == len(pos):   # a class prediction has no map
            seg_png = os.path.join(viz_dir, f"seg_{i}.png")
            plot_segmentation(pos, s["pred"], s["gt"], valid, cmap=s["cmap"],
                              path=seg_png)
            logger.log_media(f"viz/seg_{i}", seg_png)
            # the interactive figure beside the PNG, as the reference logs
            # plotly figures (visualize_plotly.py:19-331): wandb.Plotly
            # online, an .html under media/ offline
            pfig = to_plotly_figure(pos, s["pred"], valid)
            if pfig is not None:
                logger.log_media(f"viz/seg_interactive_{i}", pfig)
        # grouping edges (reference visualize_plotly.py:284-306)
        fig = grouping_edges_figure(
            pos, s["edges"], valid=valid,
            path=os.path.join(viz_dir, f"edges_{i}.png"))
        logger.log_media(f"viz/groupings_{i}", fig)
        cones = vector_cones_figure(
            pos, s["tangents"], valid=valid & s["along"],
            title="curve tangents",
            path=os.path.join(viz_dir, f"tangents_{i}.png"))
        logger.log_media(f"viz/tangents_{i}", cones)
        if s["panels"] is not None:
            logger.log_media(f"viz/panels_{i}", s["panels"])
    print(f"wrote figures to {viz_dir}")
    return viz_dir


def score_of(result: dict) -> float:
    for k in ("miou", "instance_miou", "accuracy"):
        if k in result:
            return float(result[k])
    return float("nan")


def _flag(cfg: dict, key: str) -> bool:
    """A switch of the config; a flag the file lacks arrives as a string."""
    v = cfg.get(key)
    if isinstance(v, str):
        return v.lower() not in ("", "false", "0", "no")
    return bool(v)


def device_of(cfg: dict) -> torch.device:
    """The config's device (a process's own CUDA device with more than one
    process); a CUDA device must be present."""
    device = torch.device(cfg.get("device") or DEFAULT_DEVICE)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass --device=cpu to run on the CPU)")
    if parallel.process_count() > 1:
        return parallel.local_device(device, parallel.process_index())
    return device


def _process_id(dist_cfg: dict) -> int:
    pid = dist_cfg.get("process_id")
    return int(os.environ.get("CCN_PROCESS_ID", 0) if pid is None else pid)


def init_distributed_from_config(cfg: dict) -> int:
    """Join the run's process group from the config's block (the JAX
    entry's ``init_distributed_from_config``)::

        distributed:
          coordinator_address: host0:29500
          num_processes: 2
          process_id: 0        # or the environment's CCN_PROCESS_ID

    -> this process's rank; one process (no block, ``num_processes`` <= 1)
    joins nothing."""
    dist_cfg = cfg.get("distributed") or {}
    n_proc = int(dist_cfg.get("num_processes") or 0)
    if n_proc <= 1:
        return 0
    pid = _process_id(dist_cfg)
    device = device_of(cfg)
    idx = parallel.initialize_distributed(
        dist_cfg.get("coordinator_address"), n_proc, pid, device)
    print(f"[distributed] process {idx}/{n_proc} on "
          f"{parallel.local_device(device, pid)}", flush=True)
    return idx


def _setup(cfg: dict, logger: Optional[MetricLogger] = None,
           with_optimizer: bool = False):
    """(task info, train set, val set, model on the config's device,
    optimizer or None, (start epoch, max score, optimizer step)) with the
    weights of ``weights``, of ``outdir``'s ``latest`` checkpoint (the
    optimizer's state too, and the epoch after the saved one), or random
    from ``seed``."""
    from .predict import init_weights

    device = device_of(cfg)
    info = T.task_for(cfg["dataset_source"], cfg.get("task", "segmentation"))
    train_ds, val_ds = load_datasets(cfg)
    spec = parse_model_config(cfg["model"], in_dim=train_ds.in_dim,
                              n_out=info.n_out)
    feat = train_ds.in_dim - 3
    model = CurveCloudNet(spec, n_points=train_ds.n_pad,
                          feat_channels=feat or None,
                          edge_kernel=cfg.get("edge_kernel", "group"))
    init_weights(model, torch.Generator().manual_seed(int(cfg.get("seed", 0))))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model Parameters: {n_params:,}")
    if logger is not None:
        logger.log({"model_parameters": int(n_params)})
    model = model.to(device)
    opt = (create_optimizer(model, weight_decay=float(
        cfg.get("weight_decay", 0.0))) if with_optimizer else None)
    # every process reads the same weights below; process 0's stand
    broadcast = parallel.process_count() > 1

    outdir = cfg.get("outdir", "./out/run")
    weights = cfg.get("weights", "")
    resume = (0, -1e30, 0)
    if weights:
        if weights.endswith((".pth", ".pt")):
            ckpt.load_reference_state_dict(
                model, torch.load(weights, map_location="cpu",
                                  weights_only=True))
            print(f"loaded torch weights from {weights}")
        else:
            ckpt.restore_checkpoint(os.path.dirname(weights) or ".",
                                    os.path.basename(weights), model)
    elif ckpt.has_latest(outdir):
        step = ckpt.restore_checkpoint(outdir, "latest", model, opt)
        latest = ckpt.read_latest_state(outdir) or {}
        resume = (int(latest.get("epoch", -1)) + 1,
                  float(latest.get("max_score", -1e30)), step)
        if logger is not None:
            # run-spanning statistics must see the entries before a resume
            logger.reload_history()
        print(f"resumed from {outdir} at epoch {resume[0]}")
    if broadcast:
        parallel.broadcast_state(model, opt)
    return info, train_ds, val_ds, model, opt, resume


def build(cfg: dict, logger: Optional[MetricLogger] = None):
    """(task info, val dataset, model in eval mode on the config's device)
    with the weights of ``weights``, of ``outdir``'s ``latest``
    checkpoint, or random from ``seed``."""
    info, _, val_ds, model, _, _ = _setup(cfg, logger)
    return info, val_ds, model.eval()


def train(cfg: dict, logger: MetricLogger) -> float:
    """The epoch loop (JAX ``main.py:280-413``) -> the best val score.

    Per epoch: the BN momentum ``bn_momentum_for_epoch(epoch,
    bn_momentum_decay)``; the train set shuffled and augmented from
    ``seed`` by ``PrefetchLoader``; per batch one :func:`train_step` at the
    schedule's learning rate of the optimizer's step count (a step count a
    resume restores), the sampling steps drawing from one
    ``torch.Generator`` seeded from ``seed`` (JAX splits a key per step,
    which torch cannot reproduce: docs/DEVIATIONS.md #14); every 10 steps
    the previous step's loss is logged (its copy was started without
    blocking, so the host waits for that step, not the one just queued);
    the epoch's mean loss.  Every ``val_every`` epochs ``run_eval``, the
    score and the median of the top five, and ``best_epoch{E}`` on a new
    best; ``epoch{E}`` every ``save_every`` epochs; ``latest`` and
    ``latest_state.json`` after every epoch.  With more than one process
    each trains on its shard (``PrefetchLoader``), the schedule counting
    the shard's steps, and every step is the global batch's."""
    from .data.loader import PrefetchLoader

    info, train_ds, val_ds, model, opt, resume = _setup(cfg, logger, True)
    start_epoch, max_score, step = resume
    device = next(model.parameters()).device
    outdir = cfg.get("outdir", "./out/run")
    loss_cfg = T.loss_for(cfg)
    batch_size = int(cfg.get("batch_size", 4))
    seed = int(cfg.get("seed", 0))
    # a process's steps: ceil(n / processes) items of each epoch
    shard_len = -(-len(train_ds) // parallel.process_count())
    steps_per_epoch = max(1, -(-shard_len // batch_size))
    schedule = make_schedule(cfg.get("scheduler"), float(cfg.get("lr", 1e-3)),
                             steps_per_epoch)
    epochs = int(cfg.get("epochs", 10))
    val_every = int(cfg.get("val_every", 1))
    save_every = int(cfg.get("save_every", 10))
    bn_decay = float(cfg.get("bn_momentum_decay", 0.97))
    loader = PrefetchLoader(train_ds, batch_size, shuffle=True, seed=seed,
                            augment=True,
                            num_workers=int(cfg.get("num_workers", 4)))
    generator = torch.Generator(device=device).manual_seed(seed)
    for epoch in range(start_epoch, epochs):
        t_ep = time.time()
        bn_m = bn_momentum_for_epoch(epoch, bn_decay)
        losses = []
        for np_batch in loader.epoch(epoch):
            batch = D.to_device_batch(np_batch, info.task, device)
            out = train_step(model, opt, schedule(step), batch, generator,
                             bn_m, loss_cfg)
            step += 1
            losses.append(T.stage(device, out["loss"]))
            if step % 10 == 0 and len(losses) >= 2:
                (loss,), event = losses[-2]
                T.wait(event)
                logger.log({"train_loss": float(loss)}, step=step - 1)
        for _, event in losses:
            T.wait(event)
        ep_loss = (float(np.mean([float(h[0]) for h, _ in losses]))
                   if losses else 0.0)
        print(f"epoch {epoch}: loss {ep_loss:.4f} "
              f"({time.time() - t_ep:.1f}s)")

        if (epoch + 1) % val_every == 0:
            # every process scores the val set; process 0's score decides
            score = parallel.agree(score_of(run_eval(model, val_ds, info,
                                                     cfg)))
            logger.log({"score": score, "epoch": epoch}, step=step)
            # the reference's 'Median Top 5 IOU' (nuscenes_seg.py:159-161)
            logger.log({"median_top5_score": logger.median_top_k("score")},
                       step=step)
            if score > max_score:
                max_score = score
                ckpt.save_checkpoint(outdir, f"best_epoch{epoch}", model,
                                     opt, step)
        if (epoch + 1) % save_every == 0:
            ckpt.save_checkpoint(outdir, f"epoch{epoch}", model, opt, step)
        # the preemption checkpoint (reference main.py:127-141)
        ckpt.save_checkpoint(outdir, "latest", model, opt, step)
        ckpt.dump_latest_state(outdir, epoch, max_score)
    return max_score


def _spawned(i: int, cfg: dict, n: int, address: str, out) -> None:
    """Process i of ``data_parallel_devices``: ``main`` with its block."""
    score = main(dict(cfg, data_parallel_devices=1, distributed={
        "num_processes": n, "coordinator_address": address,
        "process_id": i}))
    if i == 0:
        out.put(score)


def _data_parallel(cfg: dict) -> Optional[int]:
    """The processes ``data_parallel_devices: n`` asks for: n when n CUDA
    devices are visible (a process each), else None (one process, as the
    JAX entry runs one device when fewer are present)."""
    n = int(cfg.get("data_parallel_devices") or 1)
    dist_cfg = cfg.get("distributed") or {}
    if n <= 1 or int(dist_cfg.get("num_processes") or 0) > 1:
        return None
    device = torch.device(cfg.get("device") or DEFAULT_DEVICE)
    have = torch.cuda.device_count() if device.type == "cuda" else 0
    if have >= n:
        return n
    print(f"[distributed] data_parallel_devices {n}: {have} CUDA devices "
          "visible on the config's device; running one process", flush=True)
    return None


def main(cfg: dict) -> Optional[float]:
    """Train (the best val score), or with ``only_val`` / ``only_test``
    score the val set (mIoU, instance part mIoU or accuracy), or with
    ``only_viz`` draw :func:`run_viz`'s figures (None); with
    ``distributed.num_processes`` > 1 as one process of the run, with
    ``data_parallel_devices`` as n spawned processes."""
    n_spawn = _data_parallel(cfg)
    if n_spawn:
        import torch.multiprocessing as mp

        from .parallel.dryrun import free_port

        out = mp.get_context("spawn").SimpleQueue()
        mp.spawn(_spawned, args=(cfg, n_spawn, f"127.0.0.1:{free_port()}",
                                 out), nprocs=n_spawn, join=True)
        return out.get()
    joined = parallel.process_count() > 1   # by the caller: left joined
    init_distributed_from_config(cfg)
    try:
        return _main(cfg)
    finally:
        if not joined:
            parallel.shutdown()


def _main(cfg: dict) -> Optional[float]:
    outdir = cfg.get("outdir", "./out/run")
    os.makedirs(outdir, exist_ok=True)
    logger = MetricLogger(outdir, use_wandb=_flag(cfg, "use_wandb"),
                          config=cfg)
    try:
        if _flag(cfg, "only_viz"):
            info, val_ds, model = build(cfg, logger)
            with parallel.local():
                run_viz(model, val_ds, info, cfg, outdir, logger=logger)
            return None
        if not (_flag(cfg, "only_val") or _flag(cfg, "only_test")):
            return train(cfg, logger)
        info, val_ds, model = build(cfg, logger)
        result = run_eval(model, val_ds, info, cfg, logger=logger)
        logger.log({k: v for k, v in result.items()
                    if isinstance(v, (int, float))})
    finally:
        logger.close()
    return score_of(result)


if __name__ == "__main__":
    main(parse_args())
