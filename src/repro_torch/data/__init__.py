"""Framework-free data helpers: the byte-level tokenizer and the
deterministic token pipeline (:mod:`repro_torch.data.pipeline`)."""
