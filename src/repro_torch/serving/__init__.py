from .config import (  # noqa: F401
    EngineConfig,
    add_engine_config_args,
    engine_config_from_args,
)
from .engine import FINISH_REASONS, Request, ServingEngine  # noqa: F401
from .kv_cache import PageAllocator, pages_needed  # noqa: F401
from . import kv_cache  # noqa: F401
