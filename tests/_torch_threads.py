"""A fixture shared by the port's test modules; imports neither jax nor the
JAX package, so that the ``cuda`` cases collect on the card's machine."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads while a module of these tests runs: the suite
    runs six workers on shared cores, and torch's default of one thread
    per core slows these small models tenfold there."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
