from .harness import (
    CSV_COLUMNS, BenchRecord, read_csv, remeasure_record, roofline_bytes,
    roofline_seconds, run_benchmark, suspicious_records, sweep, write_csv,
    write_json,
)

__all__ = ["BenchRecord", "CSV_COLUMNS", "read_csv", "remeasure_record",
           "roofline_bytes", "roofline_seconds", "run_benchmark",
           "suspicious_records", "sweep", "write_csv", "write_json"]
