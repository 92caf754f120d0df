"""The port's sharding rules, parameter specs and cache specs against the JAX
package's, leaf by leaf, on both production meshes; ``placements()``; and
the meta-device parameter tree. No process group and no device: the rules
read a stand-in mesh, as tests/test_sharding_rules.py does for the
reference."""
import itertools

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed.sharding import ShardingRules as JRules  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import param_count as jax_param_count  # noqa: E402
from repro.models.params import tree_paths as jax_tree_paths  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed.sharding import P, constrain, make_rules, placements  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import abstract_params, param_count, param_specs, tree_paths  # noqa: E402

MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
OPTIONS = list(itertools.product([True, False], ["head_dim", "seq"], ["data", "model"], [False, True]))
OPTION_IDS = [f"seq{int(s)}-{k}-{e}-fsdp{int(f)}" for s, k, e, f in OPTIONS]
ARCTIC_PARAMS = 476_850_275_328  # the reference's param_count of arctic_480b's defs


class _PortMesh:
    """What the port's rules read of a ``DeviceMesh``."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


class _JaxMesh:
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


def _pair(mesh: str, seq=True, kv="head_dim", expert="data", fsdp=False):
    sizes = MESHES[mesh]
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    kw = dict(seq_shard_residual=seq, kv_shard=kv, expert_axis=expert, fsdp=fsdp)
    port = make_rules(_PortMesh(sizes), **kw)
    return port, JRules(mesh=_JaxMesh(sizes), dp=dp, tp="model", **kw)


def _rule_specs(r) -> dict:
    out = {name: getattr(r, name) for name in ("batch", "residual", "heads", "w_in", "w_out", "embed",
                                               "lm_head", "replicated")}
    for flag in (True, False):
        out[f"kv_cache({flag})"] = r.kv_cache(flag)
        out[f"ssm_state({flag})"] = r.ssm_state(flag)
    for e in (8, 16, 128):
        out[f"w_expert_in({e})"] = r.w_expert_in(e)
        out[f"w_expert_out({e})"] = r.w_expert_out(e)
    return {k: tuple(v) for k, v in out.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("seq,kv,expert,fsdp", OPTIONS, ids=OPTION_IDS)
def test_rules_equal_the_reference(mesh, seq, kv, expert, fsdp):
    port, ref = _pair(mesh, seq, kv, expert, fsdp)
    assert (port.dp, port.tp) == (ref.dp, ref.tp)
    assert (port._dp(), port._fsdp_axis(), port._data_size()) == (ref._dp(), ref._fsdp_axis(), ref._data_size())
    assert _rule_specs(port) == _rule_specs(ref)


def _specs(defs, paths) -> dict:
    return {p: (tuple(d.shape), tuple(d.spec), d.init) for p, d in paths(defs)}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_specs_equal_the_reference(arch, mesh):
    """Every leaf's shape, spec and init, for the full config, under the
    baseline rules, FSDP and expert parallelism, and without rules."""
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for kw in ({}, {"fsdp": True}, {"expert": "model"}):
        port, ref = _pair(mesh, **kw)
        assert _specs(T.param_defs(cfg, port), tree_paths) == _specs(JT.param_defs(jcfg, ref), jax_tree_paths)
    assert _specs(T.param_defs(cfg), tree_paths) == _specs(JT.param_defs(jcfg), jax_tree_paths)
    got = {p: tuple(s) for p, s in ((p, d.spec) for p, d in tree_paths(T.param_defs(cfg, port)))}
    assert got == {p: tuple(s) for p, s in _flat(param_specs(T.param_defs(cfg, port)))}


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_specs_equal_the_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for mesh, batch, kv in itertools.product(sorted(MESHES), (8, 2), ("head_dim", "seq")):
        port, ref = _pair(mesh, kv=kv)
        assert (_specs(T.cache_defs(cfg, port, batch, 4096, 128), tree_paths)
                == _specs(JT.cache_defs(jcfg, ref, batch, 4096, 128), jax_tree_paths))
    assert (_specs(T.cache_defs(cfg, None, 8, 4096, 128), tree_paths)
            == _specs(JT.cache_defs(jcfg, None, 8, 4096, 128), jax_tree_paths))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_count_equals_the_reference(arch):
    assert param_count(T.param_defs(configs.get(arch))) == jax_param_count(JT.param_defs(jconfigs.get(arch)))


def test_placements_single_multi_and_replicated_axes():
    single, multi = _PortMesh(MESHES["single"]), _PortMesh(MESHES["multi"])
    assert placements(P("data", "model"), single) == (Shard(0), Shard(1))
    assert placements(P(None, "model"), single) == (Replicate(), Shard(1))
    assert placements(P(), single) == (Replicate(), Replicate())
    # one tensor dim over two mesh dims, the first major, as in JAX
    assert placements(P(("pod", "data"), None, "model"), multi) == (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, ("pod", "data")), multi) == (Shard(1), Shard(1), Replicate())
    assert placements(P("model", "pod"), multi) == (Shard(1), Replicate(), Shard(0))


@pytest.mark.parametrize("spec,error", [
    (P(("data", "pod")), "mesh order"),  # would need a strided shard
    (P("pod"), "not in mesh axes"),
    (P("data", "data"), "twice"),
])
def test_placements_refuses(spec, error):
    mesh = _PortMesh(MESHES["multi"] if error == "mesh order" else MESHES["single"])
    with pytest.raises(ValueError, match=error):
        placements(spec, mesh)


def test_spec_compares_with_partition_spec_as_a_tuple():
    from jax.sharding import PartitionSpec

    for entries in [(), (None,), ("data", None), (("pod", "data"), "model")]:
        assert tuple(P(*entries)) == tuple(PartitionSpec(*entries))


def test_constrain_raises_on_a_plain_tensor_and_is_the_identity_without_rules():
    x = torch.zeros(2, 4, 8)
    assert constrain(x, None, "residual") is x
    port, _ = _pair("single")
    with pytest.raises(TypeError, match="not a DTensor"):
        constrain(x, port, "residual")
    with pytest.raises(TypeError, match="not a DTensor"):
        constrain(x, port, "kv_cache", True)


def test_abstract_params_of_arctic_allocate_nothing():
    """The whole arctic tree and one device's shard of it on the (16, 16)
    mesh, on the meta device: each of the 256 devices holds at least
    1/256 of the parameters and, with every expert and weight split, under
    1%."""
    cfg = configs.get("arctic_480b")
    port, ref = _pair("single")
    defs = T.param_defs(cfg, port)
    whole = [t for _, t in _flat(abstract_params(defs, torch.bfloat16))]
    shard = [t for _, t in _flat(abstract_params(defs, torch.bfloat16, port))]
    assert whole and all(t.device.type == "meta" and t.dtype == torch.bfloat16 for t in whole + shard)
    assert sum(t.numel() for t in whole) == param_count(defs) == ARCTIC_PARAMS
    assert jax_param_count(JT.param_defs(jconfigs.get("arctic_480b"), ref)) == ARCTIC_PARAMS
    per_device = sum(t.numel() for t in shard)
    assert ARCTIC_PARAMS <= 256 * per_device and 100 * per_device < ARCTIC_PARAMS
