"""Tracking and Re-ID (port of ``lameness_tpu/track``)."""
