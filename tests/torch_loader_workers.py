"""Datasets for the worker-process loader's tests. They live apart from the
test modules so that a spawned worker imports only this file (and no JAX)
when it unpickles them."""
import os


class DiesInTheWorker:
    """A dataset whose every sample ends the process that builds it."""

    def __len__(self) -> int:
        return 8

    def raw_pair(self, idx: int) -> dict:
        os._exit(3)
