"""Offline scanning simulator: rasterize meshes (kernel K11 on the card),
sample scan lines, build curve clouds and write datasets (counterpart of
``curvecloudnet_tpu/simulator/``)."""
