"""Dense graph construction (port of ``lameness_tpu/graph``)."""
