"""Batched FuSeConv vision serving on PyTorch (engine, registry, batcher,
cost model), synchronous path.

Quick start::

    from repro_torch.serving.vision import ModelRegistry, VisionServeEngine
    from repro_torch.vision import zoo

    reg = ModelRegistry(backend="cuda")     # device="cpu": plain versions
    reg.register(zoo.tiny_net(), "fuse_half")
    engine = VisionServeEngine(reg)
    rid = engine.submit("tiny_net/fuse_half", image)  # (H, W, 3) any size
    results = engine.flush()
"""
from repro_torch.serving.vision.batcher import (DEFAULT_BUCKETS, Batch,
                                                RequestQueue, VisionRequest,
                                                fit_image, form_batch)
from repro_torch.serving.vision.calibrate import LatencyCalibrator
from repro_torch.serving.vision.costmodel import (BucketPlan,
                                                  SystolicCostModel)
from repro_torch.serving.vision.engine import (VisionFuture, VisionResult,
                                               VisionServeEngine)
from repro_torch.serving.vision.metrics import ServeMetrics, percentile
from repro_torch.serving.vision.registry import (ModelRegistry,
                                                 RegisteredModel,
                                                 default_model_key)

__all__ = [
    "Batch", "BucketPlan", "DEFAULT_BUCKETS", "LatencyCalibrator",
    "ModelRegistry", "RegisteredModel", "RequestQueue", "ServeMetrics",
    "SystolicCostModel", "VisionFuture", "VisionRequest", "VisionResult",
    "VisionServeEngine", "default_model_key", "fit_image", "form_batch",
    "percentile",
]
