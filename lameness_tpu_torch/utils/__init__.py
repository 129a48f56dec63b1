"""Timing and logging (port of ``lameness_tpu/utils``)."""
