"""Multi-tenant QoS layer — runtime-facing entry point.

The implementation lives in :mod:`lumen_tpu_torch.utils.qos` for the same
reason ``utils/deadline.py`` and ``utils/trace.py`` live in ``utils``:
the torch-free serving base class (and the client) must import the tenant
contextvar, the quota gate and the retry-after meta key without dragging
in the torch-importing runtime package ``__init__``. This module re-exports
the surface runtime components use — the micro-batcher builds its
:class:`~lumen_tpu_torch.utils.qos.WFQAdmissionQueue` through here, the ingest
pipeline tags its work ``bulk`` — so runtime code has one local name for
the layer.

See :mod:`lumen_tpu_torch.utils.qos` for the full design notes: virtual-time
weighted-fair queuing over per-tenant sub-queues, the
interactive>bulk priority lanes and the brownout ladder, per-tenant token
buckets with retry-after hints, and the ``tenant_flood`` fault point.
"""

from ..utils.qos import (  # noqa: F401 - re-exported runtime surface
    DEFAULT_TENANT,
    LANE_BULK,
    LANE_INTERACTIVE,
    RETRY_AFTER_META,
    TENANT_META_KEY,
    TenantQuota,
    WFQAdmissionQueue,
    activate,
    current_lane,
    current_qos,
    current_tenant,
    deactivate,
    get_quota,
    live_queues,
    qos_context,
    reset_quota,
    retry_after_ms,
    service_extra,
    status,
    tenant_rps,
    tenant_weight,
    wfq_enabled,
)

__all__ = [
    "DEFAULT_TENANT",
    "LANE_BULK",
    "LANE_INTERACTIVE",
    "RETRY_AFTER_META",
    "TENANT_META_KEY",
    "TenantQuota",
    "WFQAdmissionQueue",
    "activate",
    "current_lane",
    "current_qos",
    "current_tenant",
    "deactivate",
    "get_quota",
    "live_queues",
    "qos_context",
    "reset_quota",
    "retry_after_ms",
    "service_extra",
    "status",
    "tenant_rps",
    "tenant_weight",
    "wfq_enabled",
]
