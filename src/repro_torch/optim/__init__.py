"""Optimizers and learning-rate schedules (port of ``repro.optim``; the
gradient compression of ``repro.optim.compression`` belongs to the LM
stack and is not ported yet)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    adamw, sgd_momentum, rmsprop, clip_by_global_norm, ema_init, ema_update,
    apply_updates, global_norm,
)
from repro_torch.optim.schedules import (  # noqa: F401
    cosine_schedule, exponential_decay, warmup_cosine,
)
