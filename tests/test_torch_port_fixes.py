"""The port's train entry, reference-checkpoint loader and compute dtype
against the JAX package on the CPU.

* KITTI train setup: 64-beam sweeps with labels in [0, 20); its loss (the
  task's Lovász weight 2, mean over all points, class weights when the
  config sets ``use_ce_weights``) equals JAX's ``_compute_loss`` with
  ``TASKS["kitti"]`` to 1e-6 relative; nuScenes' likewise;
* a reference-format ``state_dict`` (``norms.N.module.*`` names and
  ``num_batches_tracked`` counters) loads strictly into the narrow
  flagship, to the same weights as JAX's ``load_torch_checkpoint`` then
  ``from_jax_variables``, and gives JAX's logits within 2e-3;
* ``compute_dtype: bfloat16`` raises; the shipped configs compute in f32.
"""

import dataclasses
import glob
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _shrink_feat_dims
from curvecloudnet_tpu import checkpoint as jckpt
from curvecloudnet_tpu.config import load_config
from curvecloudnet_tpu.models import CurveCloudNet as JNet
from curvecloudnet_tpu.models import cloud_from_arrays as jcloud
from curvecloudnet_tpu.models import parse_model_config as jparse
from curvecloudnet_tpu.run.tasks import TASKS
from curvecloudnet_tpu.train.trainer import _compute_loss
from curvecloudnet_tpu_torch import checkpoint as tckpt
from curvecloudnet_tpu_torch import predict
from curvecloudnet_tpu_torch.models import CurveCloudNet as TNet
from curvecloudnet_tpu_torch.models import cloud_from_arrays as tcloud
from curvecloudnet_tpu_torch.models import parse_model_config as tparse
from curvecloudnet_tpu_torch.train.__main__ import setup
from curvecloudnet_tpu_torch.train.trainer import compute_loss
from torch_port_utils import lidar, to_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TRAIN = 2048
N_CKPT = 1024


def _config(tmp_path, name, **changes):
    """configs/<name>.yaml with top-level keys changed, as a new file."""
    cfg = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    cfg.update(changes)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cfg


@pytest.mark.parametrize("name,ce_weights", [("kitti", False),
                                             ("kitti", True),
                                             ("nuscenes", False)])
def test_train_setup_loss_matches_jax_task(tmp_path, name, ce_weights):
    path, cfg = _config(tmp_path, name, use_ce_weights=ce_weights)
    _, _, _, loss_cfg, batch, _ = setup(path, "cpu", 0, N_TRAIN)
    task = TASKS[name]
    n_out = task.n_out
    cid, labels = batch.cloud.curve_id, batch.labels
    valid = batch.cloud.valid
    assert int(cid[valid].max()) + 1 == predict.N_BEAMS[name]
    assert 0 <= int(labels.min()) and int(labels.max()) < n_out
    # as the JAX train entry picks it (curvecloudnet_tpu/main.py): the
    # task's loss, Lovász from the config, class weights under
    # use_ce_weights
    j_cfg = dataclasses.replace(task.loss_cfg,
                                use_lovasz=bool(cfg["use_lovasz_loss"]))
    j_weights = (jnp.asarray(task.class_weights, jnp.float32)
                 if ce_weights and task.class_weights is not None else None)
    assert (loss_cfg.class_weights is not None) == (j_weights is not None)
    rng = np.random.default_rng(5)
    logits = (2 * rng.normal(size=(1, N_TRAIN, n_out))).astype(np.float32)
    out_valid = valid.numpy() & (rng.random((1, N_TRAIN)) > 0.05)
    want = _compute_loss(jnp.asarray(logits), jnp.asarray(out_valid),
                         SimpleNamespace(labels=jnp.asarray(labels.numpy()),
                                         label_valid=None), j_cfg, j_weights)
    got = compute_loss(torch.from_numpy(logits), torch.from_numpy(out_valid),
                       batch, loss_cfg)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def _reference_format(state_dict):
    """The port's state_dict as a released reference ``.pth`` holds it:
    every other MLP BatchNorm under torch_geometric's ``norms.N.module.*``
    and a ``num_batches_tracked`` counter beside every BatchNorm."""
    out, n_module = {}, 0
    for k, v in state_dict.items():
        m = re.match(r"(.*norms\.\d+)\.(\w+)$", k)
        if m and int(m.group(1).rsplit(".", 1)[1]) % 2 == 0:
            k = f"{m.group(1)}.module.{m.group(2)}"
            n_module += 1
        out[k] = v.clone()
        if k.endswith("running_var"):
            out[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(17, dtype=torch.long)
    assert n_module and any("norm_modules" in k for k in out)
    return out


def test_reference_state_dict_loads_strictly():
    cfg = load_config(os.path.join(REPO, "configs", "nuscenes.yaml"))
    mc = _shrink_feat_dims(cfg["model"], 8)
    jspec, tspec = jparse(mc, in_dim=4, n_out=17), tparse(mc, in_dim=4,
                                                         n_out=17)
    src = TNet(tspec, N_CKPT, feat_channels=1)
    predict.init_weights(src, torch.Generator().manual_seed(3))
    ref = _reference_format(src.state_dict())

    port = TNet(tspec, N_CKPT, feat_channels=1)
    tckpt.load_reference_state_dict(port, ref)
    params, stats = jckpt.load_torch_checkpoint(
        {k: v.numpy() for k, v in ref.items()}, jspec)
    want = tckpt.from_jax_variables(params, stats, jspec)
    got = port.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    with pytest.raises(RuntimeError):
        tckpt.load_reference_state_dict(
            TNet(tspec, N_CKPT, feat_channels=1),
            {**ref, "steps.1.conv.local_nn.lins.9.weight": torch.zeros(1)})

    pos, x, cid, valid = lidar(N_CKPT, batch=1, seed=2)
    jm = JNet(jspec, n_points=N_CKPT)
    jlogits, jvalid = jax.jit(lambda v, c: jm.apply(v, c, train=False))(
        {"params": params, "batch_stats": stats},
        jcloud(*map(jnp.asarray, (pos, cid, valid, x))))
    with torch.no_grad():
        tlogits, tvalid = port.eval()(tcloud(*to_torch(pos, cid, valid, x)))
    rows = np.asarray(jvalid)
    np.testing.assert_array_equal(tvalid.numpy(), rows)
    err = np.abs(tlogits.numpy() - np.asarray(jlogits))[rows]
    assert np.isfinite(err).all() and err.max() <= 2e-3, err.max()


def test_bfloat16_compute_raises():
    cfg = load_config(os.path.join(REPO, "configs", "nuscenes.yaml"))
    mc = dict(_shrink_feat_dims(cfg["model"], 8), compute_dtype="bfloat16")
    spec = tparse(mc, in_dim=4, n_out=17)
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        TNet(spec, N_CKPT, feat_channels=1)


def test_shipped_configs_compute_in_float32():
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
    assert len(paths) >= 6
    for path in paths:
        cfg = load_config(path)
        assert tparse(cfg["model"], in_dim=4,
                      n_out=20).compute_dtype == "float32", path
    for name in ("nuscenes", "kitti"):
        path = os.path.join(REPO, "configs", f"{name}.yaml")
        model = predict.build_model(path, N_CKPT, "cpu")
        assert model.spec.compute_dtype == "float32"
