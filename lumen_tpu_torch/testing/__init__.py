"""Test-support subpackage: deterministic fault injection for the serving
stack (importable in production builds — every hook is a no-op until armed).
"""

from .faults import FaultInjected, FaultInjector, FaultRule, faults

__all__ = ["FaultInjected", "FaultInjector", "FaultRule", "faults"]
