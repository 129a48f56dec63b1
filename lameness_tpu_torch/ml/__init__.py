"""The tabular ensemble's inference (port of ``lameness_tpu/ml``)."""
