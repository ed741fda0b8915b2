import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture
def small_cell():
    """A factory: the cell ``name`` of BENCHMARK.json on a small log of
    its mix."""
    from cfbench import harness as hz

    def make(name, users=3000, items=1500, ratings=60000):
        cell = hz.Cell(hz.load_spec(), name)
        cell.mix = dict(cell.mix, num_users=users, num_items=items,
                        num_ratings=ratings)
        return cell
    return make
