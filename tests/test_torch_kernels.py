"""Kernels K1 (matcher) and K2 (DDT gather) of the PyTorch port.

On the CPU the port's plain versions are held against the JAX package's
references and its Pallas kernels (interpret mode, as tests/test_kernels.py
runs them) on shared numpy inputs.  The CUDA kernels are held against the
plain versions in tests/test_torch_cuda.py.  Tolerance: exact (0); K2 on
floats compares bit patterns.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import matching as jmatching  # noqa: E402
from repro.core import packet as jpkt  # noqa: E402
from repro.kernels.ddt import ops as jddt_ops  # noqa: E402
from repro.kernels.ddt.ref import ddt_gather_ref as jgather_ref  # noqa: E402
from repro.kernels.matcher import ops as jmatch_ops  # noqa: E402
from repro.kernels.matcher.ref import match_ref as jmatch_ref  # noqa: E402
from repro_torch.core import ddt as tddt  # noqa: E402
from repro_torch.core import matching as tmatching  # noqa: E402
from repro_torch.core import packet as tpkt  # noqa: E402
from repro_torch.kernels.ddt import ops as tddt_ops  # noqa: E402
from repro_torch.kernels.matcher import ops as tmatch_ops  # noqa: E402

W = tpkt.WORDS


# ----------------------------------------------------------------- inputs
def wire_frames(n, seed):
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        payload = rng.integers(0, 256, size=int(rng.integers(0, 64))
                               ).astype(np.uint8)
        kind = i % 5
        if kind == 0:
            frames.append(tpkt.make_icmp_echo(payload))
        elif kind == 1:
            frames.append(tpkt.make_udp(payload, dport=9999))
        elif kind == 2:
            frames.append(tpkt.make_slmp(i, 0, tpkt.SLMP_FLAG_EOM, payload))
        elif kind == 3:
            frames.append(tpkt.make_slmp(i, 64, 0, payload))
        else:
            frames.append(tpkt.make_udp(payload, dport=1234))   # no match
    return tpkt.stack_frames_np(frames)[0]


def random_frames(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, tpkt.MTU)).astype(np.uint8)


def builtin_rules():
    rs = [tmatching.ruleset_icmp_echo(), tmatching.ruleset_udp_pingpong(9999),
          tmatching.ruleset_slmp(9330), tmatching.ruleset_none()]
    rules = np.stack([r.as_array() for r in rs])
    modes = np.array([r.mode for r in rs], np.int32)
    return rules, modes


def random_rules(c, seed, idx_hi=W):
    """Random tables with idx < idx_hi; narrow masks and ranges so that
    both outcomes occur."""
    rng = np.random.default_rng(seed)
    rules = np.zeros((c, 4, 4), np.uint32)
    rules[..., 0] = rng.integers(0, idx_hi, (c, 4))
    rules[..., 1] = rng.choice(np.array([0xFF, 0xFF00, 0xF0F0F0F0,
                                         0xFFFFFFFF, 0], np.uint32), (c, 4))
    lo = rng.integers(0, 2**32, (c, 4), dtype=np.uint64)
    span = rng.integers(0, 2**31, (c, 4), dtype=np.uint64)
    rules[..., 2] = (lo & rules[..., 1]).astype(np.uint32)
    rules[..., 3] = np.minimum(lo + span, 2**32 - 1).astype(np.uint32)
    modes = rng.integers(0, 2, c).astype(np.int32)
    return rules, modes


def t_match(data, rules, modes):
    m, e = tmatch_ops.match(torch.as_tensor(data),
                            torch.as_tensor(rules.astype(np.int64)),
                            torch.as_tensor(modes))
    return m.numpy(), e.numpy()


def j_match(data, rules, modes, kernel):
    words = jpkt.bytes_to_u32be(jnp.asarray(data))
    if kernel:
        m, e = jmatch_ops.match(words, jnp.asarray(rules), jnp.asarray(modes),
                                use_kernel=True)
    else:
        m, e = jmatch_ref(words, jnp.asarray(rules), jnp.asarray(modes))
    return np.asarray(m), np.asarray(e)


# ---------------------------------------------------------------- K1 (CPU)
@pytest.mark.parametrize("frames", ["wire", "random"])
@pytest.mark.parametrize("tables", ["builtin", "random"])
@pytest.mark.parametrize("n", [1, 7, 64])
def test_match_plain_equals_jax_ref_and_pallas(frames, tables, n):
    data = wire_frames(n, n) if frames == "wire" else random_frames(n, n)
    rules, modes = builtin_rules() if tables == "builtin" else \
        random_rules(6, n + 1)
    got = t_match(data, rules, modes)
    for kernel in (False, True):
        want = j_match(data, rules, modes, kernel)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == bool and got[0].shape == (n, rules.shape[0])


def test_match_idx_beyond_words_follows_ref():
    """Reference quirk: with idx >= W the JAX ref clips to W-1 while its
    Pallas kernel selects no word (reads 0).  The port follows the ref."""
    data = random_frames(4, 3)
    data[:, -4:] = 0xFF
    rules = np.zeros((1, 4, 4), np.uint32)
    rules[0, :, 0] = [W + 5, 0, 0, W + 5]
    rules[0, :, 1] = 0xFFFFFFFF
    rules[0, 1:3, 1] = 0
    rules[0, :, 2:] = 0                    # range [0, 0]
    modes = np.zeros(1, np.int32)
    got = t_match(data, rules, modes)
    np.testing.assert_array_equal(got[0], j_match(data, rules, modes,
                                                  False)[0])
    assert not got[0].any()                # word W-1 = 0xFFFFFFFF != 0
    assert j_match(data, rules, modes, True)[0].all()   # Pallas: reads 0


def test_match_batch_lowest_context_wins():
    data = wire_frames(20, 5)
    valid = np.ones(20, bool)
    valid[3] = False
    rs_t = [tmatching.ruleset_slmp(9330), tmatching.ruleset_udp_pingpong(
        9330), tmatching.ruleset_icmp_echo()]
    rs_j = [jmatching.ruleset_slmp(9330), jmatching.ruleset_udp_pingpong(
        9330), jmatching.ruleset_icmp_echo()]
    length = np.full(20, 100, np.int32)
    tb = tpkt.PacketBatch.from_numpy(data, length, valid, "cpu")
    ctx, eom = tmatching.match_batch(
        tb, tmatching.MatchTables.build(rs_t, device="cpu"))
    jctx, jeom = jmatching.match_batch(
        jpkt.PacketBatch(jnp.asarray(data), jnp.asarray(length),
                         jnp.asarray(valid)),
        jmatching.MatchTables.build(rs_j))
    np.testing.assert_array_equal(ctx.numpy(), np.asarray(jctx))
    np.testing.assert_array_equal(eom.numpy(), np.asarray(jeom))
    assert ctx.dtype == torch.int32 and (ctx.numpy() == 0).any()
    assert ctx.numpy()[3] == -1


@pytest.mark.parametrize("mode", [tmatching.MODE_AND, tmatching.MODE_OR])
@pytest.mark.parametrize("frames", ["wire", "random"])
@pytest.mark.parametrize("c", [1, 3, 8])
def test_match_batch_fused_plain_equals_jax(c, frames, mode):
    """The port's match_batch (the fused form's plain version on the CPU)
    against the JAX package's match_batch: random contexts in ``mode``
    with word indices up to W + 7 (clipped to W - 1), built-in contexts
    between them, and invalid lanes."""
    n = 40
    data = wire_frames(n, c) if frames == "wire" else random_frames(n, c)
    rules, modes = random_rules(c, 100 + c, idx_hi=W + 8)
    modes[:] = mode
    b_rules, b_modes = builtin_rules()
    for k in range(1, c, 2):
        rules[k], modes[k] = b_rules[k // 2 % 3], b_modes[k // 2 % 3]
    valid = np.random.default_rng(c).random(n) < 0.8
    length = np.full(n, 200, np.int32)
    ctx, eom = tmatching.match_batch(
        tpkt.PacketBatch.from_numpy(data, length, valid, "cpu"),
        tmatching.MatchTables(torch.as_tensor(rules.astype(np.int64)),
                              torch.as_tensor(modes)))
    jctx, jeom = jmatching.match_batch(
        jpkt.PacketBatch(jnp.asarray(data), jnp.asarray(length),
                         jnp.asarray(valid)),
        jmatching.MatchTables(jnp.asarray(rules), jnp.asarray(modes)))
    assert ctx.dtype == torch.int32 and eom.dtype == torch.bool
    np.testing.assert_array_equal(ctx.numpy(), np.asarray(jctx))
    np.testing.assert_array_equal(eom.numpy(), np.asarray(jeom))
    assert (ctx.numpy()[~valid] == -1).all()
    if frames == "wire" and c > 1:
        assert (ctx.numpy() >= 0).any()


def test_match_first_rejects_bad_valid():
    rules, modes = builtin_rules()
    args = (torch.zeros((3, 1536), dtype=torch.uint8),
            torch.as_tensor(rules.astype(np.int64)), torch.as_tensor(modes))
    for valid in (torch.ones(3, dtype=torch.int32), torch.ones(4,
                                                               dtype=bool)):
        with pytest.raises(ValueError):
            tmatch_ops.match_first(*args, valid)
    ctx, eom = tmatch_ops.match_first(*args, torch.ones(3, dtype=bool))
    assert ctx.shape == eom.shape == (3,)


def test_match_rejects_bad_inputs():
    rules, modes = builtin_rules()
    with pytest.raises(ValueError):
        tmatch_ops.match(torch.zeros((2, 1535), dtype=torch.uint8),
                         torch.as_tensor(rules.astype(np.int64)),
                         torch.as_tensor(modes))
    with pytest.raises(ValueError):
        tmatch_ops.match(torch.zeros((2, 1536), dtype=torch.uint8),
                         torch.as_tensor(rules.astype(np.int32)),
                         torch.as_tensor(modes))


# ---------------------------------------------------------------- K2 (CPU)
def gather_inputs(dtype, s, i, seed):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        src = rng.normal(size=s).astype(np.float32)
        src[::7] = -0.0
    elif dtype == "int32":
        src = rng.integers(-2**31, 2**31, size=s).astype(np.int32)
    else:
        src = rng.integers(0, 256, size=s).astype(np.uint8)
    idx = rng.integers(-1, s, size=i).astype(np.int32)
    return src, idx


def bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8"])
@pytest.mark.parametrize("s,i", [(16, 16), (100, 777), (513, 1025),
                                 (2048, 64)])
def test_gather_plain_equals_jax_ref_and_pallas(dtype, s, i):
    src, idx = gather_inputs(dtype, s, i, s * 31 + i)
    got = tddt_ops.gather(torch.as_tensor(src), torch.as_tensor(idx)).numpy()
    ref = np.asarray(jgather_ref(jnp.asarray(src), jnp.asarray(idx)))
    np.testing.assert_array_equal(bits(got), bits(ref))
    pallas = np.asarray(jddt_ops.gather(jnp.asarray(src), jnp.asarray(idx),
                                        use_kernel=True))
    if dtype == "float32":
        # reference quirk: the Pallas compare-and-sum turns -0.0 into +0.0
        np.testing.assert_array_equal(got, pallas)
    else:
        np.testing.assert_array_equal(bits(got), bits(pallas))


def test_gather_reference_quirks_negative_zero_and_idx_beyond_source():
    """The port follows the JAX ref: -0.0 survives the gather (the Pallas
    kernel gives +0.0), and idx >= S clips to S-1 (the Pallas kernel gives
    0)."""
    src = np.array([1.5, -0.0, 2.5, 7.0], np.float32)
    idx = np.array([1, 9, -1, 0], np.int32)
    got = tddt_ops.gather(torch.as_tensor(src), torch.as_tensor(idx),
                          fill=3.0).numpy()
    ref = np.asarray(jgather_ref(jnp.asarray(src), jnp.asarray(idx), 3.0))
    np.testing.assert_array_equal(bits(got), bits(ref))
    assert np.signbit(got[0]) and got[1] == 7.0 and got[2] == 3.0
    pallas = np.asarray(jddt_ops.gather(jnp.asarray(src), jnp.asarray(idx),
                                        fill=3.0, use_kernel=True))
    assert not np.signbit(pallas[0]) and pallas[1] == 0.0


def test_pack_unpack_equal_jax_on_fig9_maps():
    for base in (tddt.simple_ddt(), tddt.complex_ddt()):
        c = tddt.commit(base, count=5)
        pack_idx, unpack_idx = tddt.element_maps(c, 4)
        rng = np.random.default_rng(0)
        mem = rng.normal(size=c.mem_bytes // 4).astype(np.float32)
        dst = rng.normal(size=c.mem_bytes // 4).astype(np.float32)
        msg = tddt_ops.pack(torch.as_tensor(mem), torch.as_tensor(pack_idx))
        jmsg = jddt_ops.pack(jnp.asarray(mem), jnp.asarray(pack_idx))
        np.testing.assert_array_equal(bits(msg.numpy()), bits(jmsg))
        out = tddt_ops.unpack(msg, torch.as_tensor(unpack_idx),
                              torch.as_tensor(dst))
        jout = jddt_ops.unpack(jmsg, jnp.asarray(unpack_idx),
                               jnp.asarray(dst))
        np.testing.assert_array_equal(bits(out.numpy()), bits(jout))


def test_fill_bits_patterns():
    assert tddt_ops.fill_bits(-0.0, torch.float32) == 0x80000000
    assert tddt_ops.fill_bits(-1, torch.int32) == 0xFFFFFFFF
    assert tddt_ops.fill_bits(1.0, torch.bfloat16) == 0x3F80
    assert tddt_ops.fill_bits(255, torch.uint8) == 0xFF


def test_gather_rejects_bad_inputs():
    with pytest.raises(ValueError):
        tddt_ops.gather(torch.zeros(4), torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        tddt_ops.gather(torch.zeros(0), torch.zeros(3, dtype=torch.int32))


def test_build_all_keeps_compiler_report_of_a_built_library(tmp_path,
                                                           monkeypatch):
    """A library that an earlier process built (no nvcc run now) still
    yields its ptxas report, which chip_smoke.py checks."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "build_logs", {})
    lib = build._lib_path("matcher")
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("ptxas info    : Used 32 registers")
    build.build_all(["matcher"])
    assert build.build_logs == {"matcher": "ptxas info    : Used 32 registers"}
