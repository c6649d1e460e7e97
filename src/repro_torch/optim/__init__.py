"""The optimizer stack of the port: AdamW (in place) + schedule +
clipping, and int8 gradient compression (``repro.optim`` counterpart)."""
from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig,
    OptState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from repro_torch.optim.compress import (  # noqa: F401
    compress_int8,
    decompress_int8,
)
