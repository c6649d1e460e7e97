"""The port's runs write their artefacts under ``experiments/torch/``: no
default of the port (its modules and ``chip_smoke.py``) names the JAX
package's ``experiments/dryrun`` or ``experiments/obs``, which the JAX
package's renderers read as TPU records."""
import inspect
import re
from pathlib import Path

import pytest

from repro_torch.obs import report

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
# "experiments/obs", "experiments" / "obs", os.path.join("experiments", "obs")
REFERENCE_DIRS = re.compile(
    r"""experiments["']?\s*(?:/|,)\s*["']?(dryrun|obs)\b""")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_default_names_the_reference_artefacts(path):
    hits = [m.group(0) for m in REFERENCE_DIRS.finditer(path.read_text())]
    assert not hits, f"{path.relative_to(ROOT)} names {hits}"


def test_pattern_sees_each_spelling():
    for text in ('"experiments/obs"', '"experiments" / "obs"',
                 'join("experiments", "dryrun")', "experiments/dryrun/x"):
        assert REFERENCE_DIRS.search(text), text
    assert not REFERENCE_DIRS.search('"experiments/torch/obs"')


@pytest.mark.parametrize("fn", [report.stall_report,
                                report.availability_report,
                                report.serve_report])
def test_report_defaults_are_the_port_directory(fn):
    default = inspect.signature(fn).parameters["out_dir"].default
    assert default == "experiments/torch/obs"
