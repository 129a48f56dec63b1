"""The serving driver (port of ``lameness_tpu/serve``)."""
