"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
repository's root. Tests marked `cuda` need the card and skip elsewhere."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def tiny_cell():
    """A cell of the tiny configuration on the CPU: two pairs a call."""
    from portbench import spec

    return spec.Cell(name="tiny-b2", chips=1, config=json.loads((DATA / "tiny.json").read_text()),
                     mix=json.loads((DATA / "tiny-mix.json").read_text()),
                     end_to_end=[{"name": "pairs_per_s", "unit": "pairs/s"}, {"name": "setup_s", "unit": "s"}],
                     per_layer=[], root=ROOT)


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
