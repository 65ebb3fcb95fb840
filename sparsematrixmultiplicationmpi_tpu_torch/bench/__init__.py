from .harness import BenchRecord, roofline_bytes, roofline_seconds, run_benchmark

__all__ = ["BenchRecord", "roofline_bytes", "roofline_seconds",
           "run_benchmark"]
