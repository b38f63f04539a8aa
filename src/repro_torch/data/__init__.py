"""Data pipelines: the vision training path's and the LM token pipeline
(port of ``repro.data``)."""
from repro_torch.data.vision_synth import synth_image_batch, SynthVisionConfig  # noqa: F401
from repro_torch.data.prefetch import Prefetcher  # noqa: F401
from repro_torch.data.tokens import TokenConfig, TokenPipeline  # noqa: F401
