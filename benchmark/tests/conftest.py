import pytest
import torch

from benchmark.tests import tiny


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return tiny.make(str(tmp_path_factory.mktemp("tiny")))
