"""The serving layer, GNN and combined lanes: config, cache,
micro-batcher, engine, the adaptive flush policy and the fleet of engine
replicas; the replay harness (``serve.replay``) and the HTTP transport
(``serve.http``) import on their own."""

from deepdfa_tpu_torch.serve.batcher import (  # noqa: F401
    MicroBatcher,
    OversizedError,
    RejectedError,
    ServeRequest,
)
from deepdfa_tpu_torch.serve.cache import ResultCache, content_hash  # noqa: F401
from deepdfa_tpu_torch.serve.config import (  # noqa: F401
    MAX_REPLICAS,
    REPLICA_IDS,
    ServeConfig,
)
from deepdfa_tpu_torch.serve.engine import BadRequestError, ServeEngine  # noqa: F401
from deepdfa_tpu_torch.serve.fleet import Replica, ServeFleet  # noqa: F401
from deepdfa_tpu_torch.serve.policy import AdaptiveFlushPolicy  # noqa: F401
