"""Training and durability: the train step and loop
(:mod:`repro_torch.train.train_loop`), checkpoints in the reference's
on-disk format (:mod:`repro_torch.train.checkpoint`) and failure recovery
(:mod:`repro_torch.train.fault_tolerance`)."""
