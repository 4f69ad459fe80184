from .metrics import GordoServerPrometheusMetrics

__all__ = ["GordoServerPrometheusMetrics"]
