"""Processes over the mesh's data axis (``snap_tpu/parallel``)."""
