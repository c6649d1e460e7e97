"""The paper's own memory-system configuration (§III-B/§V): 8 data banks,
8 cores, queue depth 10, schemes I/II/III, alpha/r sweeps per Fig 18; the
port's copy of ``repro/configs/paper_memsys.py``."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class MemSysConfig:
    scheme: str = "scheme_i"
    n_data: int = 8
    n_cores: int = 8
    n_rows: int = 512
    alpha: float = 1.0
    r: float = 0.05
    queue_depth: int = 10
    select_period: int = 256


PAPER_ALPHAS = (0.05, 0.1, 0.25, 0.5, 1.0)
PAPER_SCHEMES = ("scheme_i", "scheme_ii", "scheme_iii")
