"""Capacity-telemetry layer — runtime-facing entry point.

The implementation lives in :mod:`lumen_tpu_torch.utils.telemetry` for the same
reason ``utils/qos.py`` and ``utils/trace.py`` live in ``utils``: the
torch-free serving layer (router, observability sidecar, client) must read
rolling-window stats, SLO state and the flight recorder without dragging
in the torch-importing runtime package ``__init__``. This module re-exports
the surface runtime components feed — the micro-batcher credits
``device:{name}`` busy intervals and per-batch padding/transfer counts,
the decode pool credits ``decode:{name}`` worker time — so runtime code
has one local name for the layer.

See :mod:`lumen_tpu_torch.utils.telemetry` for the full design notes: ring-
buffered time buckets, union- vs sum-mode duty meters, the SLO burn-rate
engine and the incident flight recorder.
"""

from ..utils.telemetry import (  # noqa: F401 - re-exported runtime surface
    INCIDENT_KINDS,
    SLO_META_KEY,
    busy,
    capacity_stats,
    count,
    count_error,
    device_duty,
    duty_fraction,
    enabled,
    export_events,
    export_incidents,
    forecast_rate,
    get_hub,
    install_hub,
    observe,
    record_event,
    reset_hub,
    set_capacity,
    slo_report,
    slo_status,
    telemetry_enabled,
    window_total,
)

__all__ = [
    "INCIDENT_KINDS",
    "SLO_META_KEY",
    "busy",
    "capacity_stats",
    "count",
    "count_error",
    "device_duty",
    "duty_fraction",
    "enabled",
    "export_events",
    "export_incidents",
    "forecast_rate",
    "get_hub",
    "install_hub",
    "observe",
    "record_event",
    "reset_hub",
    "set_capacity",
    "slo_report",
    "slo_status",
    "telemetry_enabled",
    "window_total",
]
