"""Vision training loops (port of ``repro.train.vision``; the LM trainer
and its checkpoints are not ported yet)."""
