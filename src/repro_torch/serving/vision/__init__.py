"""Batched FuSeConv vision serving on PyTorch (engine, registry, batcher,
cost model).

Quick start::

    from repro_torch.serving.vision import ModelRegistry, create_engine
    from repro_torch.vision import zoo

    reg = ModelRegistry(backend="cuda")     # device="cpu": plain versions
    reg.register(zoo.tiny_net(), "fuse_half")
    engine = create_engine(reg, "pipelined")       # or "sync"
    engine.warmup()
    rid = engine.submit("tiny_net/fuse_half", image)  # (H, W, 3) any size
    results = engine.flush()

Every engine conforms to ``interface.ServingEngine`` (submit / poll /
stream_results / warmup / snapshot / close).  Port of
``repro.serving.vision``, with the kernel build cache
(``ModelRegistry(compilation_cache_dir=...)``) and the warmup manifest
(``engine.warmup(manifest_path=...)``).  ``ModelRegistry(mesh=
launch.mesh.make_data_mesh(n))`` serves over a data mesh with cross-model
rounds; ``multiproc.py`` spreads that mesh over processes.
"""
from repro_torch.serving.vision.batcher import (DEFAULT_BUCKETS, Batch,
                                                RequestQueue, VisionRequest,
                                                fit_image, form_batch,
                                                form_round)
from repro_torch.serving.vision.calibrate import LatencyCalibrator, z_score
from repro_torch.serving.vision.compilecache import (
    enable_compilation_cache, persistent_cache_counters)
from repro_torch.serving.vision.costmodel import (BucketPlan, RoundPart,
                                                  RoundPlan,
                                                  SystolicCostModel,
                                                  power_of_two_partitions,
                                                  round_groups, uneven_sizes)
from repro_torch.serving.vision.engine import (ReadinessProbe, VisionFuture,
                                               VisionResult,
                                               VisionServeEngine)
from repro_torch.serving.vision.interface import (ENGINES,
                                                  PipelinedVisionEngine,
                                                  ServingEngine,
                                                  SyncVisionEngine,
                                                  create_engine,
                                                  register_engine)
from repro_torch.serving.vision.metrics import (LatencyStat, ServeMetrics,
                                                percentile)
from repro_torch.serving.vision.multiproc import (LocalExec,
                                                  MultiprocessCoordinator,
                                                  PartHandle,
                                                  local_exec_plan,
                                                  publish_mesh_fingerprint,
                                                  run_worker,
                                                  slice_local_rows,
                                                  stitch_shards)
from repro_torch.serving.vision.registry import (BatchLogits, ModelRegistry,
                                                 RegisteredModel,
                                                 default_model_key,
                                                 device_groups,
                                                 device_groups_sized)
from repro_torch.serving.vision.sketch import (DEFAULT_QUANTILES, P2Quantile,
                                               QuantileSketch)
from repro_torch.serving.vision.tenancy import (DEFAULT_CLASS, SLO_CLASSES,
                                                SLOClass, class_priority,
                                                class_weight, jain_fairness,
                                                slo_class)
from repro_torch.serving.vision.traffic import (ARRIVAL_PATTERNS, TenantSpec,
                                                make_mixed_burst,
                                                make_tenant_trace,
                                                stream_items,
                                                stream_mixed_burst,
                                                submit_mixed_burst,
                                                submit_trace)

__all__ = [
    "ARRIVAL_PATTERNS", "Batch", "BatchLogits", "BucketPlan",
    "DEFAULT_BUCKETS", "DEFAULT_CLASS", "DEFAULT_QUANTILES", "ENGINES",
    "LatencyCalibrator", "LatencyStat", "LocalExec", "ModelRegistry",
    "MultiprocessCoordinator", "P2Quantile", "PartHandle",
    "PipelinedVisionEngine", "QuantileSketch", "ReadinessProbe",
    "RegisteredModel", "RequestQueue", "RoundPart", "RoundPlan", "SLOClass",
    "SLO_CLASSES", "ServeMetrics", "ServingEngine", "SyncVisionEngine",
    "SystolicCostModel", "TenantSpec", "VisionFuture", "VisionRequest",
    "VisionResult", "VisionServeEngine", "class_priority", "class_weight",
    "create_engine", "default_model_key", "device_groups",
    "device_groups_sized", "enable_compilation_cache", "fit_image",
    "form_batch", "form_round", "jain_fairness", "local_exec_plan",
    "make_mixed_burst", "make_tenant_trace", "percentile",
    "persistent_cache_counters", "power_of_two_partitions",
    "publish_mesh_fingerprint", "register_engine", "round_groups",
    "run_worker", "slice_local_rows", "slo_class", "stitch_shards",
    "stream_items", "stream_mixed_burst", "submit_mixed_burst",
    "submit_trace", "uneven_sizes", "z_score",
]
