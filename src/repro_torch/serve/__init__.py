"""repro_torch.serve — the batched serving engine over the dense LM."""
