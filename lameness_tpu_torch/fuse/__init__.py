"""Fusion (port of ``lameness_tpu/fuse``)."""
