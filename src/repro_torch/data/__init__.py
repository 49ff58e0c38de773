"""repro_torch.data — deterministic synthetic streams (numpy)."""
