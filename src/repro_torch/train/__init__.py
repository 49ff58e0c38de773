"""repro_torch.train — the LM's loss gradient (``trainer._grads``, with
microbatch accumulation).  The optimizer and the train step are not
ported yet (ROADMAP.md queue 1, "LM training")."""
