"""Serving: the batch and streaming servers and the drift watchdog."""

from repro_torch.serving.engine import QWYCServer, ServeStats, StreamingServer
from repro_torch.serving.watchdog import DriftWatchdog, WatchdogConfig

__all__ = [
    "DriftWatchdog",
    "QWYCServer",
    "ServeStats",
    "StreamingServer",
    "WatchdogConfig",
]
