"""One BLAS thread for a test module: ``from torch_threads import
one_blas_thread`` in a module that makes its LAPACK calls (QRs of
2^k x 2^k unitaries, 4^k-element products) with tier-1's other workers
running beside it. There OpenBLAS's threads of each process wait on each
other: six processes each taking a QR of a 2048 x 2048 complex matrix took
207-211 s on an 8-core host, against 3.2-3.4 s on one thread each."""

import pytest
import threadpoolctl


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield
