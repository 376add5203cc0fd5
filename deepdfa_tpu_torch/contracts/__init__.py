"""Data contracts at the serve admission edge."""

from deepdfa_tpu_torch.contracts.schema import (  # noqa: F401
    ContractError,
    validate_example,
)
