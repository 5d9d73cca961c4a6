"""One torch intra-op thread for a port test module.

The port's tests work on small tensors. With torch's default of one thread
per core, each module contends for the cores that the suite's other test
workers use (``pytest -n 6``), and the whole run slows. A module pins one
thread for its duration with

    from tests.torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
