"""Launchers: the single-device LM training launcher
(:mod:`repro_torch.launch.train`) and its ``--opt`` layout transform
(:mod:`repro_torch.launch.dryrun`)."""
