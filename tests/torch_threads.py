"""One intra-op thread for torch in each test process.

The suite runs its files in several worker processes at once (pytest-xdist,
``-n``). Left at torch's default, each worker starts one intra-op thread per
core, so the workers together oversubscribe the cores many times over and a
test that takes half a second alone can take minutes. Every port test file
imports this module, directly or through ``torch_port_helpers``, so the
setting holds whichever file a worker collects first. It imports nothing
but torch: the card's tests run without the suite's conftest and without
JAX, and import it too."""

import torch

torch.set_num_threads(1)
