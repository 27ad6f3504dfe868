"""Launchers: the LM training launcher (:mod:`repro_torch.launch.train`),
the dry run over the production meshes (:mod:`repro_torch.launch.dryrun`,
with the launcher's ``--opt`` transform ``apply_opt``), its input
stand-ins (:mod:`repro_torch.launch.input_specs`) and its meshes
(:mod:`repro_torch.launch.mesh`)."""
