"""Human-in-the-loop consensus and ranking (port of ``lameness_tpu/hitl``)."""
