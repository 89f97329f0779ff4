"""Process-global application state (reference ``services/state.py:43-265``;
the port's copy of the JAX package's ``app/state.py``).

Holds the cached config, the install task store, the managed-server handle,
and the pub/sub log broadcast: every WebSocket subscriber gets its own
bounded ``asyncio.Queue`` fed by ``broadcast_log`` (reference
``state.py:201-237``); slow consumers drop oldest instead of blocking the
producer.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any

logger = logging.getLogger(__name__)

LOG_QUEUE_SIZE = 512


@dataclass
class LogEvent:
    message: str
    level: str = "info"
    source: str = "app"
    ts: float = field(default_factory=time.time)

    def as_dict(self) -> dict[str, Any]:
        return {"message": self.message, "level": self.level, "source": self.source, "ts": self.ts}


class AppState:
    """One instance per app process; handed to every API handler."""

    def __init__(self) -> None:
        from collections import deque

        self.config = None  # LumenConfig | None (last generated/loaded)
        self.config_path: str | None = None
        self.install_tasks: dict[str, Any] = {}  # task_id -> InstallTask
        self.server_manager = None  # set by api.build_app
        self._subscribers: set[asyncio.Queue[LogEvent]] = set()
        #: ring buffer behind GET /server/logs and /install/logs — WS
        #: subscribers only see lines from after they connect; the REST
        #: endpoints (reference api/server.py:21-234, api/install.py:85-243)
        #: serve recent history.
        self.recent_logs: "deque[LogEvent]" = deque(maxlen=500)
        #: server lines separately: a chatty install must not evict the
        #: managed server's history out from under GET /server/logs
        self.server_logs: "deque[LogEvent]" = deque(maxlen=500)
        self._lock = asyncio.Lock()
        self._loop: asyncio.AbstractEventLoop | None = None

    # -- lifecycle --------------------------------------------------------

    def bind_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        """Remember the serving loop so threads can broadcast safely."""
        self._loop = loop

    # -- log pub/sub ------------------------------------------------------

    def subscribe(self) -> asyncio.Queue[LogEvent]:
        q: asyncio.Queue[LogEvent] = asyncio.Queue(maxsize=LOG_QUEUE_SIZE)
        self._subscribers.add(q)
        return q

    def unsubscribe(self, q: asyncio.Queue[LogEvent]) -> None:
        self._subscribers.discard(q)

    def broadcast_log(self, message: str, level: str = "info", source: str = "app") -> None:
        """Fan a log line out to all subscribers. Safe from the event loop;
        threads must use :meth:`broadcast_log_threadsafe`."""
        event = LogEvent(message=message, level=level, source=source)
        self.recent_logs.append(event)
        if source == "server":
            self.server_logs.append(event)
        for q in list(self._subscribers):
            try:
                q.put_nowait(event)
            except asyncio.QueueFull:
                try:  # drop oldest so the stream stays live for slow readers
                    q.get_nowait()
                    q.put_nowait(event)
                except asyncio.QueueEmpty:
                    pass

    def broadcast_log_threadsafe(self, message: str, level: str = "info", source: str = "app") -> None:
        """Bridge for worker threads (reference ``install_orchestrator.py:674-693``)."""
        if self._loop is None or self._loop.is_closed():
            return
        self._loop.call_soon_threadsafe(self.broadcast_log, message, level, source)

    @property
    def subscriber_count(self) -> int:
        return len(self._subscribers)
