"""lameness_tpu_torch.parallel"""
