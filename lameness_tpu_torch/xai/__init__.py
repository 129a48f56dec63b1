"""Explanations: Shapley values, the SHAP service and the LLM text (port
of ``lameness_tpu/xai``)."""
