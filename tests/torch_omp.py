"""Imported by the port's test modules before torch: OpenMP threads that
wait for work sleep instead of spinning.

Each pytest worker runs torch's OpenMP pool (one thread per core) beside
XLA's threads. Spinning pools starve each other under several workers: the
port's CPU test files took about four times as long. The thread count, and
so every result, stays the same. An ``OMP_WAIT_POLICY`` already set wins.
"""

import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
