from .config import (  # noqa: F401
    ConfigError,
    EngineConfig,
    SamplingParams,
    add_engine_config_args,
    engine_config_from_args,
)
from .engine import (  # noqa: F401
    FINISH_REASONS,
    EngineOverloaded,
    EngineStats,
    Request,
    ServingEngine,
    TokenEvent,
)
from .kv_cache import PageAllocator, pages_needed  # noqa: F401
from .router import (  # noqa: F401
    DEAD,
    DRAINING,
    HEALTHY,
    Replica,
    ReplicaSet,
    Router,
    RouterConfig,
)
from .chaos import (  # noqa: F401
    ChaosHarness,
    DrainReplica,
    FaultPlan,
    InjectNaN,
    KillReplica,
    PagePressure,
    StallSteps,
)
from .scheduler import StepScheduler  # noqa: F401
from .spec_decode import SpecConfig  # noqa: F401
from . import chaos  # noqa: F401
from . import kv_cache  # noqa: F401
from . import router  # noqa: F401
