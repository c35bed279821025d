"""Visualization layer (a copy of ``curvecloudnet_tpu/visualization/``:
NumPy and matplotlib, which figure files need; plotly and Mitsuba upgrade
transparently when installed)."""

from .mitsuba_render import (
    have_mitsuba,
    render_points,
    render_segmentation_panels,
    save_png,
)
from .plots import (
    grouping_edges_figure,
    label_colormap,
    nocs_figure,
    plot_confusion,
    plot_curve_cloud,
    plot_segmentation,
    render_bev,
    to_plotly_figure,
    vector_cones_figure,
)

__all__ = [
    "grouping_edges_figure",
    "have_mitsuba",
    "label_colormap",
    "nocs_figure",
    "plot_confusion",
    "plot_curve_cloud",
    "plot_segmentation",
    "render_bev",
    "render_points",
    "render_segmentation_panels",
    "save_png",
    "to_plotly_figure",
    "vector_cones_figure",
]
