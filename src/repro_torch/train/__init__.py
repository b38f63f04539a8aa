"""Training loops: vision (port of ``repro.train.vision``) and the LM
trainer with its checkpoints (``repro.train.{trainer,checkpoint}``)."""
