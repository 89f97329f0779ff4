"""Small framework-free helpers the port keeps its own copies of. Free of
torch: every decode-pool worker process imports this package."""

from .logger import get_logger, setup_logging

__all__ = ["setup_logging", "get_logger"]
