"""repro_torch.stream — the streaming runtime: chunked ingestion with
scan/vmem dispatch and per-chunk telemetry."""
from repro_torch.stream.ingest import (DoubleBufferedLoader,
                                       NonFiniteChunkError, finite_guard,
                                       select_path)
from repro_torch.stream.runtime import RuntimeConfig, StreamRuntime
from repro_torch.stream.telemetry import ChunkMetrics, Telemetry

__all__ = ["ChunkMetrics", "DoubleBufferedLoader", "NonFiniteChunkError",
           "RuntimeConfig", "StreamRuntime", "Telemetry", "finite_guard",
           "select_path"]
