"""Deterministic synthetic data pipeline (host-sharded, prefetched): the
port's copy of ``repro.data``."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    Prefetcher,
    TokenStream,
    make_batch,
)
