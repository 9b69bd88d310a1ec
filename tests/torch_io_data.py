"""Picklable datasets for the port's DataLoader worker tests
(tests/test_torch_io.py). Spawned workers unpickle a dataset by importing
its module, so these live in a module that imports numpy alone: a worker
pays for neither jax nor the test module's imports."""
import numpy as np


class Rows:
    """Row i: a float32 vector of `width` values i, i+1, ..., and the label
    i % 7 (an int). Duck-types a map-style Dataset."""

    def __init__(self, n=37, width=5):
        self.n, self.width = n, width

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.arange(i, i + self.width, dtype=np.float32), i % 7
