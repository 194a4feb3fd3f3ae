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
from repro_torch.kernels.checksum import ref as tck_ref  # noqa: E402


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


def _edge_lengths(start):
    """The lengths at the edges of the live range: negative, 0, around
    ``start`` and around the MTU (past it too)."""
    return [-7, -1, 0, start - 1, start, start + 1, tpkt.MTU - 1, tpkt.MTU,
            tpkt.MTU + 7]


@pytest.mark.parametrize("start", [0, 34, 35])
def test_checksum_edge_lengths_vs_jax(start):
    rng = np.random.default_rng(100 + start)
    lengths = np.array(_edge_lengths(start) * 2, np.int32)
    n = len(lengths)
    data = rng.integers(1, 256, (n, tpkt.MTU)).astype(np.uint8)
    got = tck.internet_checksum_batch(torch.tensor(data),
                                      torch.tensor(lengths), start)
    ref, pallas = _jax_both(data, lengths, start)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), pallas)
    # no live word: the sum is 0 and the checksum 0xFFFF
    dead = (lengths + 1) // 2 <= start // 2
    np.testing.assert_array_equal(got.numpy()[dead], 0xFFFF)


@pytest.mark.parametrize("start", [0, 34, 35])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 16, 17])
def test_checksum_tile_edge_batches_vs_jax(n, start):
    """N at the edges of the kernel's 8-packet block, odd lengths over
    non-zero bytes, so the byte after an odd length counts."""
    rng = np.random.default_rng(1000 * n + start)
    data = rng.integers(1, 256, (n, tpkt.MTU)).astype(np.uint8)
    lengths = rng.integers(0, tpkt.MTU + 1, n).astype(np.int32) | 1
    lengths[::4] = np.resize(_edge_lengths(start), len(lengths[::4]))
    got = tck.internet_checksum_batch(torch.tensor(data),
                                      torch.tensor(lengths), start)
    ref, pallas = _jax_both(data, lengths, start)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("start", [0, 34, 35, 1530])
def test_live_byte_ranges_cover_the_jax_mask(start):
    """The 16-byte chunks the kernel reads hold every live word of the JAX
    reference's mask, lie inside the row, are 16-byte aligned and are no
    wider than the live bytes rounded out to 16."""
    width = tpkt.MTU
    lengths = np.concatenate([np.arange(-3, width + 20), _edge_lengths(start),
                              [2**31 - 1]]).astype(np.int32)
    lo, hi = (t.numpy() for t in tck_ref.live_byte_ranges(
        torch.tensor(lengths), start, width))
    w_iota = np.arange(width // 2)[None, :]
    # the reference's int32 arithmetic: 2**31 - 1 wraps and has no live word
    w_end = np.asarray(jnp.asarray(lengths) + 1) // 2
    mask = (w_iota >= start // 2) & (w_iota < w_end[:, None])
    assert not mask[-1].any()
    byte = 2 * w_iota
    assert ((byte >= lo[:, None]) & (byte + 2 <= hi[:, None]) | ~mask).all()
    assert ((0 <= lo) & (lo <= hi) & (hi <= width)).all()
    assert (lo % 16 == 0).all() and (hi % 16 == 0).all()
    live = mask.any(axis=1)
    np.testing.assert_array_equal(hi > lo, live)
    first = np.where(live, mask.argmax(axis=1), 0)
    last = np.where(live, width // 2 - 1 - mask[:, ::-1].argmax(axis=1), 0)
    np.testing.assert_array_equal(lo[live], (2 * first[live]) // 16 * 16)
    np.testing.assert_array_equal(hi[live],
                                  -(-(2 * last[live] + 2) // 16) * 16)


@pytest.mark.parametrize("start", [0, 34])
def test_checksum_length_int32_max_vs_jax(start):
    """A length of 2**31 - 1: the JAX reference and kernel take
    (length + 1) // 2 in int32, where it wraps negative, so no word is live
    (0xFFFF); the port follows them."""
    rng = np.random.default_rng(9)
    data = np.repeat(rng.integers(1, 256, (1, tpkt.MTU)).astype(np.uint8),
                     3, axis=0)
    lengths = np.array([2**31 - 1, tpkt.MTU, 2**31 - 2], np.int32)
    got = tck.internet_checksum_batch(torch.tensor(data),
                                      torch.tensor(lengths), start).numpy()
    ref, pallas = _jax_both(data, lengths, start)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    assert got[0] == 0xFFFF and got[1] == got[2] != 0xFFFF
