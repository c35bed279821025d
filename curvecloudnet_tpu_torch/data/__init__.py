"""Input data of the port: synthetic lidar sweeps and object scans."""

from .synthetic import lidar_batch, lidar_sweep, object_batch, object_scan

__all__ = ["lidar_batch", "lidar_sweep", "object_batch", "object_scan"]
