"""Plots of maps, scenes and features (``snap_tpu/viz``)."""
