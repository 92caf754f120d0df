"""The port's parameter tree against the JAX package's: same paths and
shapes, and JAX-initialised leaves cross into torch bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.models.params import tree_paths as jax_tree_paths  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params, tree_paths  # noqa: E402

ARCH = "qwen3_0_6b"
BITS = {"float32": (np.uint32, torch.int32), "bfloat16": (np.uint16, torch.int16)}


def _flatten(tree, prefix=""):
    for k in sorted(tree):
        path = f"{prefix}/{k}"
        if isinstance(tree[k], dict):
            yield from _flatten(tree[k], path)
        else:
            yield path, tree[k]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_jax_tree_converts_bit_for_bit(arch, dtype):
    defs = JT.param_defs(jconfigs.get_smoke(arch))
    tree = jax.tree.map(np.asarray, jax_init_params(defs, seed=0, dtype=getattr(jnp, dtype)))
    converted = params_from_numpy(tree, device="cpu")
    want, got = dict(_flatten(tree)), dict(_flatten(converted))
    assert list(got) == [p for p, _ in jax_tree_paths(defs)]
    np_bits, torch_bits = BITS[dtype]
    for path, arr in want.items():
        t = got[path]
        assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == arr.shape, path
        np.testing.assert_array_equal(
            t.view(torch_bits).numpy().view(np_bits), arr.view(np_bits), err_msg=path
        )


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_port_param_defs_match_reference(arch):
    """Same /-paths, shapes and init kinds; the port's own init fills the
    same tree."""
    jdefs = dict(jax_tree_paths(JT.param_defs(jconfigs.get_smoke(arch))))
    cfg = configs.get_smoke(arch)
    tdefs = dict(tree_paths(T.param_defs(cfg)))
    assert list(tdefs) == list(jdefs)
    for path, d in tdefs.items():
        assert (d.shape, d.init, d.scale) == (jdefs[path].shape, jdefs[path].init, jdefs[path].scale)
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cpu")
    assert [p for p, _ in _flatten(params)] == list(tdefs)
    assert all(tuple(t.shape) == tdefs[p].shape for p, t in _flatten(params))


def test_port_init_is_deterministic_per_path():
    cfg = configs.get_smoke(ARCH)
    a = dict(_flatten(init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cpu")))
    b = dict(_flatten(init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cpu")))
    c = dict(_flatten(init_params(T.param_defs(cfg), seed=1, dtype=torch.float32, device="cpu")))
    assert all(torch.equal(a[p], b[p]) for p in a)
    wq = "/blocks/p0/attn/wq"
    assert not torch.equal(a[wq], c[wq])
    # std 1/sqrt(fan_in) as in the reference
    assert abs(a[wq].std().item() - cfg.d_model**-0.5) < 0.1 * cfg.d_model**-0.5
