from repro_torch.serving.telemetry import (Histogram, MetricsRegistry,
                                           Tracer, safe_ratio)

__all__ = ["Histogram", "MetricsRegistry", "Tracer", "safe_ratio"]
