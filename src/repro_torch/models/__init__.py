"""Language models on torch tensors: layers, the Mamba2 block and the
model assembly (ssm family)."""
