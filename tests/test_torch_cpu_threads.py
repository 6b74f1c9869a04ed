"""The port's CPU tests run torch on one intra-op thread.

pytest-xdist runs the suite in several worker processes that share the machine's cores,
and torch's intra-op pool (a thread a core in every worker) oversubscribes them: small
tensor ops then wait on each other's threads. Six processes of one K4 schedule test at
once took 295 s with eight threads each and 15 s with one. Every worker imports this
module while it collects, before any test runs, so the setting holds for the whole run.
"""
import torch

torch.set_num_threads(1)


def test_torch_runs_on_one_intra_op_thread():
    assert torch.get_num_threads() == 1
