"""The port's tests run torch with one intra-op thread per process.

The suite runs under pytest-xdist with about one worker per core; torch's
default of one OpenMP thread per core in every worker puts several times as
many spinning threads as there are cores, and the tiny-shape tests spend
most of their time waiting on each other's threads.  Any test file that
imports this module sets it for its whole process (an xdist worker imports
every test file when it collects, before it runs a test), so the setting
holds for every test the process runs.
"""

import torch

torch.set_num_threads(1)
