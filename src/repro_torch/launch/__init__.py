"""Launchers: the single-device LM training launcher
(:mod:`repro_torch.launch.train`)."""
