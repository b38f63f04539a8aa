"""Optimizers, learning-rate schedules and int8 gradient compression (port
of ``repro.optim``; ``compression.compressed_psum`` waits for ROADMAP
Queue 1 item 7)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    adamw, sgd_momentum, rmsprop, clip_by_global_norm, ema_init, ema_update,
    apply_updates, global_norm,
)
from repro_torch.optim.schedules import (  # noqa: F401
    cosine_schedule, exponential_decay, warmup_cosine,
)
