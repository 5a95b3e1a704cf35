"""Imported by the port's test modules before torch: OpenMP threads that
wait for work sleep instead of spinning.

Each pytest worker runs torch's OpenMP pool (one thread per core) beside
XLA's threads. Spinning pools starve each other under several workers: the
port's CPU test files took about four times as long. The thread count, and
so every result, stays the same. An ``OMP_WAIT_POLICY`` already set wins.

``pinned_threads`` fixes torch's intra-op thread count for a block: torch
splits its CPU reductions by that count, so a run whose margin is thin
gives the same numbers on every host only with the count pinned.
"""

import contextlib
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")


@contextlib.contextmanager
def pinned_threads(n: int):
    """torch's intra-op threads set to ``n`` inside the block, restored
    after it."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
