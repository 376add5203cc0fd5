"""Data contracts at every boundary the port reads: cached JSONL corpora
(validated, with a fail-closed quarantine) and serve admission."""

from deepdfa_tpu_torch.contracts.ingest import (  # noqa: F401
    load_examples_jsonl,
    write_examples_jsonl,
)
from deepdfa_tpu_torch.contracts.quarantine import (  # noqa: F401
    Quarantine,
    quarantine_dir,
    read_manifest,
)
from deepdfa_tpu_torch.contracts.schema import (  # noqa: F401
    CHECKSUM_KEY,
    FATAL_REASONS,
    REASONS,
    REPAIRABLE_REASONS,
    STATS,
    ContractError,
    row_checksum,
    validate_cache_row,
    validate_example,
)
