from trident.core.config import EngineConfig, RenderConfig, AiConfig
from trident.core.log import get_logger, ConsoleLog
from trident.core.timing import Time, FrameTimingRing
from trident.core.ids import new_uuid

__all__ = [
    "EngineConfig",
    "RenderConfig",
    "AiConfig",
    "get_logger",
    "ConsoleLog",
    "Time",
    "FrameTimingRing",
    "new_uuid",
]
