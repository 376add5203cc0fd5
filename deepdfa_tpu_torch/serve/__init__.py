"""The serving layer, GNN lane: config, cache, micro-batcher, engine."""

from deepdfa_tpu_torch.serve.batcher import (  # noqa: F401
    MicroBatcher,
    OversizedError,
    RejectedError,
    ServeRequest,
)
from deepdfa_tpu_torch.serve.cache import ResultCache, content_hash  # noqa: F401
from deepdfa_tpu_torch.serve.config import ServeConfig  # noqa: F401
from deepdfa_tpu_torch.serve.engine import BadRequestError, ServeEngine  # noqa: F401
