"""Parity of the PyTorch port's fabric with the JAX package's on the CPU:
``tests/test_net.py``'s two-node SLMP transfers on the uniform tick path,
lossless, under loss, and with jitter, duplication and reordering.  The
two fabrics tick in lockstep; every link's state is compared after every
tick, and at the end the ticks, ``stats()``, the receiver's host bytes,
completions, retransmits and NIC states.  Tolerance: exact (0).  The
helpers are ``tests/test_torch_net.py``'s (the file is split to keep each
under its time budget).
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_net import JAX, PORT, lockstep, slmp_pair  # noqa: E402


SLMP_CASES = {
    "lossless": dict(nbytes=20_000, loss=0.0),
    "loss_0.15": dict(nbytes=40_000, loss=0.15),
    "loss_0.1_jitter5_dup": dict(nbytes=20_000, loss=0.1, jitter=5,
                                 duplicate=0.2),
    "loss_0.1_jitter5_dup_reorder": dict(nbytes=20_000, loss=0.1, jitter=5,
                                         duplicate=0.2, reorder=0.2),
}


@pytest.mark.parametrize("case", list(SLMP_CASES))
def test_fabric_slmp_equals_jax(case):
    kw = SLMP_CASES[case]
    jfab, jsender, jb, msg = slmp_pair(JAX, **kw)
    tfab, tsender, tb, _ = slmp_pair(PORT, **kw)
    assert tfab._uniform
    lockstep(jfab, tfab, 5000)
    assert tsender.done and not tsender.failed
    assert tsender.sender.retransmits == jsender.sender.retransmits
    assert tsender.sender.sent_frames == jsender.sender.sent_frames
    np.testing.assert_array_equal(tb.read_host(0, len(msg)), msg)
    np.testing.assert_array_equal(tb.read_host(0, 1 << 17),
                                  jb.read_host(0, 1 << 17))
    if kw["loss"] > 0:
        assert tsender.sender.retransmits > 0
        assert tfab.link_stats()[1]["lost"] > 0


