"""One thread for PyTorch and for the BLAS libraries in the port's tests.

The suite runs six worker processes on one machine.  At the port tests'
tiny sizes extra threads only get in each other's way: PyTorch's intra-op
pool, OpenBLAS (numpy's and scipy's, eight threads each that spin while
they wait) and OpenCV's pool would start one thread per core in every
worker, and a test that used them took many times as long inside the
suite as alone.  This module sets PyTorch to one thread when it is imported and
holds the BLAS pools and OpenCV's at one thread while a port test module
runs (``one_blas_thread``, an autouse fixture: a port test module imports
it, so the JAX suite's modules keep their own settings).  It imports
neither JAX nor the JAX package.
"""
import pytest
import scipy.linalg  # noqa: F401  (loads scipy's BLAS, so the limit holds it)
import torch
from threadpoolctl import threadpool_limits

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    try:
        import cv2
    except ImportError:
        cv2 = None
    cv_threads = cv2.getNumThreads() if cv2 is not None else None
    if cv2 is not None:
        cv2.setNumThreads(1)
    try:
        with threadpool_limits(limits=1, user_api="blas"):
            yield
    finally:
        if cv2 is not None:
            cv2.setNumThreads(cv_threads)
