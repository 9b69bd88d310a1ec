"""One intra-op thread for torch in the port's CPU tests.

The tier-1 run spreads the suite over several xdist workers on one host,
and each worker imports every test module at collection. torch's default
intra-op pool is as wide as the host, so each worker running a port test
spun up that many OpenMP threads beside the other workers' torch and XLA
threads: the port's tests spent most of their time oversubscribed (on an
8-core host with six workers, the bench ResNet-50 step of
test_torch_vision.py took 63 s in the suite and 7 s alone). Importing
this module sets the pool to one thread for the process; every
tests/test_torch_*.py module imports it, so a port test computes the same
as before on fewer threads, whichever file a worker draws first. Results
do not depend on it beyond the summation order of torch's parallel CPU
reductions, which the tests' tolerances cover.
"""
import torch

torch.set_num_threads(1)
