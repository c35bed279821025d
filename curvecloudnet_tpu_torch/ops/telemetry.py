"""Scoped overflow/truncation telemetry (counterpart of
``curvecloudnet_tpu/ops/telemetry.py``).

The static budgets of the representation (downsampled rows, curve
windows, grid cells, the curve budget of the conv gap layout, the fp
split) each drop work past their size.  Every lossy site records how
much it dropped under the JAX package's key names, so the eval loop can
report overflow instead of truncating silently.

The JAX package also records ``tile_gather_spill.*``, the spill of its
TPU gather's per-tile row budget (``ops/pallas_gather.py``); the port's
K4 gathers every row with no such budget, so it has no such record.

Records are device tensors: nothing here or at a site syncs the host.
With no capture active, a site pays one ``is None`` test::

    with telemetry.capture() as cap:
        logits, valid = model(cloud)
        stats = cap.current()      # {name: 0-dim tensor}
"""

from __future__ import annotations

_REC: dict | None = None


class capture:
    """Activate recording for the enclosed calls; nests safely."""

    def __enter__(self):
        global _REC
        self._prev = _REC
        _REC = {}
        return self

    def current(self) -> dict:
        """The records so far (call before the scope closes)."""
        return dict(_REC or {})

    def __exit__(self, *exc):
        global _REC
        self.values = _REC
        _REC = self._prev
        return False


def active() -> bool:
    return _REC is not None


def record(name: str, value) -> None:
    """Record a scalar under ``name`` (suffixed ``.1``, ``.2``, ... when a
    site fires again)."""
    if _REC is None:
        return
    key, i = name, 0
    while key in _REC:
        i += 1
        key = f"{name}.{i}"
    _REC[key] = value
