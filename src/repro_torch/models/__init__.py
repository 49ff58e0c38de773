"""repro_torch.models — the LM stack, dense family: config, layers and the
transformer's forward, prefill and decode."""
