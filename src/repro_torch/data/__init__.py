"""Data pipelines of the vision training path (port of ``repro.data``; the
LM token pipeline is not ported yet)."""
from repro_torch.data.vision_synth import synth_image_batch, SynthVisionConfig  # noqa: F401
from repro_torch.data.prefetch import Prefetcher  # noqa: F401
