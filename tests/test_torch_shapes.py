"""The PyTorch port's ``configs/shapes.py`` against the JAX package's:
the shape suites, ``cell_supported`` over every arch and shape, the
abstract stand-ins of ``input_specs`` (meta tensors in the port, JAX's
``ShapeDtypeStruct``s: kinds, names, shapes, dtypes) and the concrete
inputs drawn from one seed (equal element for element; the port's float
stubs are float32 copies of what JAX then casts to the model dtype, so
they are held to JAX's arrays cast to float32 before that cast)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402

ARCHS = list(jconfigs.ARCHS)


def test_suites_equal_jax():
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, s in jshapes.SHAPES.items():
        assert dataclasses.asdict(tshapes.SHAPES[name]) == \
            dataclasses.asdict(s)
    assert tshapes.LONG_CONTEXT_ARCHS == jshapes.LONG_CONTEXT_ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_supported_equals_jax(arch):
    assert list(tconfigs.ARCHS) == ARCHS
    for shape in jshapes.SHAPES:
        assert tshapes.cell_supported(arch, shape) == \
            jshapes.cell_supported(arch, shape)


def _abstract(tree):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_input_specs_equal_jax(arch):
    """Kinds, entries, shapes and dtypes of every cell's stand-ins; the
    port's are meta tensors (vlm's ``positions`` an int32 (3, B, S)
    leaf, as in JAX)."""
    for shape in jshapes.SHAPES:
        jkind, jb = jshapes.input_specs(jconfigs.get_config(arch), shape)
        tkind, tb = tshapes.input_specs(tconfigs.get_config(arch), shape)
        assert tkind == jkind
        assert all(v.device.type == "meta" for v in tb.values())
        assert _abstract(tb) == {k: (tuple(v.shape), str(v.dtype))
                                 for k, v in jb.items()}, (arch, shape)


def _np(v):
    return np.asarray(jnp.asarray(v, jnp.float32)
                      if jnp.issubdtype(v.dtype, jnp.floating) else v)


@pytest.mark.parametrize("arch", ARCHS)
def test_concrete_inputs_equal_jax_for_one_seed(arch):
    """train, prefill and decode inputs at a small size from one seed,
    and the decode cells' ``input_specs(concrete=True)`` at full size;
    with rng None each array draws from a fresh ``default_rng(0)``, as
    in JAX."""
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    for fn in ("train_batch_specs", "prefill_batch_specs", "decode_specs"):
        for seed in (7, None):
            def rng():
                return None if seed is None else np.random.default_rng(seed)
            jb = getattr(jshapes, fn)(jc, 24, 3, concrete=True, rng=rng())
            tb = getattr(tshapes, fn)(tc, 24, 3, rng())
            assert list(tb) == list(jb)
            for k in jb:
                j = jb[k]
                if jnp.issubdtype(j.dtype, jnp.floating):
                    # JAX casts the float32 draws to the model dtype
                    assert tb[k].dtype == np.float32
                    np.testing.assert_array_equal(
                        np.asarray(jnp.asarray(tb[k], j.dtype), np.float32),
                        _np(j))
                else:
                    assert tb[k].dtype == np.asarray(j).dtype
                    np.testing.assert_array_equal(tb[k], np.asarray(j))
    for shape in ("decode_32k", "long_500k"):
        jkind, jb = jshapes.input_specs(jconfigs.get_config(arch), shape,
                                        concrete=True,
                                        rng=np.random.default_rng(3))
        tkind, tb = tshapes.input_specs(tconfigs.get_config(arch), shape,
                                        concrete=True,
                                        rng=np.random.default_rng(3))
        assert tkind == jkind == "decode"
        for k in jb:
            np.testing.assert_array_equal(tb[k], np.asarray(jb[k]))
            assert tb[k].dtype == np.asarray(jb[k]).dtype
