"""The batched checksum (K3) of the PyTorch port against the JAX package,
on the CPU: the port's plain version, through ``internet_checksum_batch``
on CPU tensors, against the JAX ``checksum_ref`` and ``checksum_pallas``
(interpret mode, through its padding wrapper, as tests/test_kernels.py
runs it) on the same numpy inputs.  Tolerance: exact (bit for bit).

Random buffers keep non-zero bytes past each length, so an odd length
shows which byte the last word pairs with.  The CUDA kernel is held
against the plain version in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.checksum import ops as jck_ops  # noqa: E402
from repro.kernels.checksum.ref import checksum_ref as jck_ref  # noqa: E402
from repro_torch.core import checksum as tck  # noqa: E402
from repro_torch.core import packet as tpkt  # noqa: E402


def _jax_both(data, lengths, start):
    d, ln = jnp.asarray(data), jnp.asarray(lengths)
    return (np.asarray(jck_ref(d, ln, start)),
            np.asarray(jck_ops.internet_checksum(d, ln, start=start,
                                                 use_kernel=True)))


@pytest.mark.parametrize("start", [0, 34, 35])
def test_checksum_random_frames_vs_jax(start):
    rng = np.random.default_rng(start)
    n = 100                                       # not a multiple of 128
    data = rng.integers(1, 256, (n, tpkt.MTU)).astype(np.uint8)
    lengths = rng.integers(0, tpkt.MTU + 1, n).astype(np.int32)
    lengths[:6] = [0, 1, 33, 35, start + 1, tpkt.MTU]
    assert (lengths % 2).any() and (lengths % 2 == 0).any()
    got = tck.internet_checksum_batch(torch.tensor(data),
                                      torch.tensor(lengths), start)
    assert got.dtype == torch.int64 and got.shape == (n,)
    ref, pallas = _jax_both(data, lengths, start)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(
        tck.internet_checksum_1(torch.tensor(data), torch.tensor(lengths),
                                start).numpy(), ref)


def test_checksum_icmp_echo_frames_vs_jax():
    """Wire-correct ICMP echo requests: their embedded checksum makes the
    sum over the ICMP message 0."""
    rng = np.random.default_rng(7)
    frames = [tpkt.make_icmp_echo(rng.integers(
        0, 256, int(rng.integers(0, 900))).astype(np.uint8), seq=i)
        for i in range(64)]
    data, lengths, _ = tpkt.stack_frames_np(frames)
    assert (lengths % 2).any()
    got = tck.internet_checksum_batch(torch.tensor(data),
                                      torch.tensor(lengths), tpkt.L4_BASE)
    ref, pallas = _jax_both(data, lengths, tpkt.L4_BASE)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), np.zeros(64))


def test_checksum_wrapper_rejects_bad_inputs():
    d = torch.zeros((4, tpkt.MTU), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tck.internet_checksum_batch(d, torch.zeros(4, dtype=torch.int64), 34)
    with pytest.raises(ValueError):
        tck.internet_checksum_batch(d, torch.zeros(3, dtype=torch.int32), 34)
    with pytest.raises(ValueError):
        tck.internet_checksum_batch(d, torch.zeros(4, dtype=torch.int32), -2)
