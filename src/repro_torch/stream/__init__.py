"""repro_torch.stream — the streaming runtime: chunked ingestion with
scan/vmem dispatch, the pool lifecycle and per-chunk telemetry."""
from repro_torch.stream.ingest import (DEFAULT_VMEM_BUDGET,
                                       DoubleBufferedLoader,
                                       NonFiniteChunkError, finite_guard,
                                       select_path)
from repro_torch.stream.lifecycle import (FailureBuffer, LifecycleConfig,
                                          LifecycleReport)
from repro_torch.stream.runtime import RuntimeConfig, StreamRuntime
from repro_torch.stream.telemetry import ChunkMetrics, Telemetry

__all__ = ["ChunkMetrics", "DEFAULT_VMEM_BUDGET", "DoubleBufferedLoader",
           "FailureBuffer", "LifecycleConfig", "LifecycleReport",
           "NonFiniteChunkError", "RuntimeConfig", "StreamRuntime",
           "Telemetry", "finite_guard", "select_path"]
