"""The port's tests share the host's cores with the other test workers.

pytest-xdist runs the suite in several worker processes, and by default
each gives torch one intra-op thread per core, so the workers' threads
fight over the cores and every tiny CPU op pays for it.  Importing this
module (every `tests/test_torch_*.py` does, first) gives this process
its share of the cores: all of them to a lone run, one each to six
workers on eight cores.  Inter-op threads are left as they are: torch
refuses to change them once inter-op work has started.
"""
import os

import torch

THREADS = max(1, os.cpu_count()
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))

torch.set_num_threads(THREADS)
