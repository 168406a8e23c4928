"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*).

Each parity test feeds the same numpy inputs, made from a seed, to a
reference (JAX) function and to its port, and compares the results leaf
by leaf.  Integer outputs (the FENIX data plane) must be equal
(``assert_same``); floating-point outputs (the LM substrate) are held to
a stated tolerance (``assert_close``).
"""

import numpy as np
import pytest


def to_numpy(x):
    """A JAX array, torch tensor, number or nested dict/list -> numpy
    (int64 for integers, so uint32 and int64-held uint32 compare)."""
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_numpy(v) for v in x]
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    if a.dtype.kind in "iub":
        return a.astype(np.int64)
    return a


def assert_same(ref, port, where=""):
    """Exact leaf-by-leaf equality of two nested results."""
    r, p = to_numpy(ref), to_numpy(port)
    if isinstance(r, dict):
        assert sorted(r) == sorted(p), (where, sorted(r), sorted(p))
        for k in r:
            assert_same(r[k], p[k], f"{where}.{k}")
        return
    if isinstance(r, list):
        assert len(r) == len(p), where
        for i, (a, b) in enumerate(zip(r, p)):
            assert_same(a, b, f"{where}[{i}]")
        return
    assert r.shape == p.shape, (where, r.shape, p.shape)
    assert np.array_equal(r, p), (where, np.argwhere(r != p)[:5])


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: the Hopper kernels have no CPU mode."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the hand-written "
                    "Hopper kernels have no CPU mode")
    return torch.device("cuda")


def assert_close(ref, port, tol, where=""):
    """Floating-point results within ``tol`` of the reference's largest
    magnitude: max |ref - port| <= tol * max |ref| (leaf by leaf; NaNs
    must sit at the same places).  Each caller states why its ``tol``."""
    r = np.asarray(to_numpy(ref), np.float64)
    p = np.asarray(to_numpy(port), np.float64)
    assert r.shape == p.shape, (where, r.shape, p.shape)
    nan = np.isnan(r)
    assert np.array_equal(nan, np.isnan(p)), (where, "NaN positions differ")
    if nan.all():
        return
    err = np.abs(r - p)[~nan].max()
    scale = max(np.abs(r[~nan]).max(), 1e-30)
    assert err <= tol * scale, (where, f"max|diff| {err:.3g} > {tol} x "
                                       f"max|ref| {scale:.3g}")
