"""Seconds of ``Auto.prepare`` (``auto_format`` then ``.to(device)``),
host clock, ended by a synchronize."""


def read(run):
    return run.setup.get("format_build_s")
