"""Frame formats for the engine's ingest (port of ``lameness_tpu/video``)."""
