"""Optimizers and gradient compression as plain functions on parameter
trees (nested dicts of tensors): AdamW (:mod:`repro_torch.optim.optimizers`)
and top-k gradient compression with error feedback
(:mod:`repro_torch.optim.grad_compression`)."""
