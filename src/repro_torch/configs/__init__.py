"""repro_torch.configs subpackage."""
