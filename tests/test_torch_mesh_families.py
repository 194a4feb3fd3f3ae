"""The PyTorch port's mesh Trainer against the JAX package's pjit
``Trainer`` for the moe, ssm, hybrid, encdec and vlm families, on the CPU,
on (data 2, model 2), with tests/test_torch_mesh.py's harness and
tolerances: one JAX subprocess with four fake host devices, one spawn of
four gloo ranks, each of three steps from the JAX state before it.

Cases, float32: qwen2-moe-smoke at ``moe_capacity_factor`` 1.0, so that
(token, expert) pairs drop (the same ones as under pjit: the dispatch
runs over the global tokens; experts split over ``model``); mamba2-smoke
with FSDP (``out_proj`` split over ``model``, ``in_proj`` whole);
recurrentgemma-smoke (the LRU width over ``model``; 2 query heads over 1
KV head); whisper-smoke with ragged ``enc_len`` (split over ``data``
like the batch); qwen2-vl-smoke with its three M-RoPE components drawn
apart (``positions`` split on dim 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import shapes as tshapes  # noqa: E402
from test_torch_mesh import (_cfg, _spawn, check_forced_steps,  # noqa: E402
                             check_placements, dense_batch, mesh_rank,
                             run_jax)
from test_torch_vlm import _distinct_positions  # noqa: E402

MESH = {"data": 2, "model": 2}
CASES = [
    {"name": "qwen2-moe-cap1", "arch": "qwen2-moe-a2.7b", "micro": 1,
     "fsdp": False, "mesh": MESH, "over": {"moe_capacity_factor": 1.0}},
    {"name": "mamba2-fsdp", "arch": "mamba2-780m", "micro": 1, "fsdp": True,
     "mesh": MESH},
    {"name": "recurrentgemma", "arch": "recurrentgemma-9b", "micro": 1,
     "fsdp": False, "mesh": MESH},
    {"name": "whisper-ragged", "arch": "whisper-tiny", "micro": 1,
     "fsdp": False, "mesh": MESH},
    {"name": "qwen2-vl-mrope", "arch": "qwen2-vl-2b", "micro": 1,
     "fsdp": False, "mesh": MESH},
]
IDS = [c["name"] for c in CASES]


def batch_of(case):
    cfg = _cfg(case)
    if cfg.family not in ("encdec", "vlm"):
        return dense_batch(cfg)
    b = tshapes.train_batch_specs(cfg, 20, 4, np.random.default_rng(2))
    if cfg.family == "encdec":
        e = cfg.enc_seq
        b["enc_len"] = np.array([e, e * 4 // 5, e * 7 // 15, e // 3],
                                np.int32)
    else:
        b["positions"] = _distinct_positions(4, 20, seed=3)
    return b


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("families")
    run_jax(CASES, outdir, batch_of)
    return outdir, _spawn(mesh_rank, 4, outdir, str(outdir), CASES, False)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_trainer_forced_steps_vs_jax(results, case):
    """Three forced steps against the JAX pjit ``Trainer``'s."""
    outdir, ranks = results
    check_forced_steps(outdir, ranks, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_trainer_placements_and_local_heads(results, case):
    """Parameters and moments placed by the rules with sharded local
    shapes; no parameter's shard gathered over ``model``; every attention
    call on the rank's batch rows and local query heads."""
    _, ranks = results
    check_placements(ranks, case)
    tc = _cfg(case)
    for r in ranks:
        assert r["cases"][case["name"]]["gathered_over_model"] == []
        seen = r["cases"][case["name"]]["attention"]
        assert (tc.family == "ssm") == (not seen)
        for q, k in seen:
            assert q[0] == 2 and q[2] == tc.n_heads // 2, seen
            assert k[0] == 2 and k[2] == max(1, tc.n_kv_heads // 2), seen


def test_moe_drops_pairs_over_the_global_tokens(results):
    """At capacity factor 1.0 pairs drop, and every rank dispatches the
    global tokens (all 4 x 20 x top_k assignments) and keeps the same
    ones; the losses match the JAX package's (the forced-step test), so
    the dropped pairs are pjit's."""
    _, ranks = results
    tc = _cfg(CASES[0])
    drops = [r["cases"]["qwen2-moe-cap1"]["drops"] for r in ranks]
    assert all(d == drops[0] for d in drops[1:])
    for total, kept in drops[0]:
        assert total == 4 * 20 * tc.top_k
        assert kept < total
    leaves = ranks[0]["cases"]["qwen2-moe-cap1"]["leaves"]["params"]
    place, local, shape = leaves["['blocks'][0]['moe']['up']"]
    assert place[1].is_shard(0) and local[0] == shape[0] // 2
