"""The port's logical-axis sharding against the JAX package's, with no
process (and, but for the round trips, no parameter value): the ten rule tables, every leaf's logical
axes through the spec trees of the ten full configurations,
``localize_specs`` and the local pool's segment table at model 2 (and
the configurations both packages refuse at model 3), the ten smoke
configurations' local specs at model 2, ``param_pspecs``,
``count_params``, the shard/unshard round trip of ``convert`` (bitwise
from JAX's initial weights for the expert, codebook and inner-width
leaves of every family), and ``launch.mesh``'s ``mesh_topology`` and
one-process meshes."""
import types

import jax
import numpy as np
import pytest

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_arch as j_get_arch
from repro.configs import get_smoke as j_get_smoke
from repro.core.pool import GradientPool as JPool
from repro.launch import mesh as j_mesh
from repro.models import build_model as j_build
from repro.parallel import cost_model as j_cost
from repro.parallel import sharding as j_sh
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_arch, get_smoke, rules_for
from repro_torch.core.pool import GradientPool as TPool
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import build_model as t_build
from repro_torch.models import params as t_params
from repro_torch.parallel import cost_model as t_cost
from repro_torch.parallel import sharding as t_sh


def _specs(tree, prefix=()):
    """[(path, shape, axes)] of a spec tree (nested dicts, sorted keys)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _specs(v, prefix + (k,))
        else:
            out.append(("/".join(prefix + (k,)), tuple(v.shape),
                        tuple(v.axes)))
    return out


@pytest.fixture(scope="module")
def spec_trees():
    return {a: (j_build(j_get_arch(a)[0]).param_specs(),
                t_build(get_arch(a)[0]).param_specs()) for a in ARCH_IDS}


def test_rule_tables_equal_jax():
    assert ARCH_IDS == tuple(J_ARCH_IDS)
    assert t_sh.DEFAULT_RULES == j_sh.DEFAULT_RULES
    assert t_sh.make_rules(kv_heads=None, expert_mlp="model") == \
        j_sh.make_rules(kv_heads=None, expert_mlp="model")
    for arch in ARCH_IDS:
        cfg, rules = get_arch(arch)
        assert rules == dict(j_get_arch(arch)[1]), arch
        assert get_smoke(arch)[1] == rules
        assert rules_for(cfg) == rules == rules_for(get_smoke(arch)[0])
    with pytest.raises(KeyError):
        rules_for(types.SimpleNamespace(name="no-such-model"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_equal_jax(arch, spec_trees):
    j_specs, t_specs = spec_trees[arch]
    assert _specs(t_specs) == _specs(j_specs)
    rules = get_arch(arch)[1]
    want = jax.tree_util.tree_leaves(
        j_sh.param_pspecs(j_specs, rules),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = [p for _, p in _flat(t_sh.param_pspecs(t_specs, rules))]
    assert got == [tuple(p) for p in want]
    assert t_sh.count_params(t_specs) == j_sh.count_params(j_specs)


def _flat(tree, prefix=()):
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flat(v, prefix + (k,))
        else:
            out.append(("/".join(prefix + (k,)), v))
    return out


def _localize(mod, specs, rules, m):
    try:
        return mod.localize_specs(specs, rules, m)
    except AssertionError as e:
        return str(e)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_specs_and_pool_equal_jax(arch, spec_trees):
    j_specs, t_specs = spec_trees[arch]
    rules = get_arch(arch)[1]
    j_loc = _localize(j_sh, j_specs, rules, 2)
    t_loc = _localize(t_sh, t_specs, rules, 2)
    assert not isinstance(j_loc, str), j_loc  # every config divides by 2
    assert _specs(t_loc) == _specs(j_loc)
    for pad in (1, 32768):
        j_pool = JPool(j_sh.abstract_params(j_loc), pad_to=pad)
        t_pool = TPool(t_params.param_shapes(t_loc), pad_to=pad)
        assert [(s.name, s.shape, s.offset, s.size) for s in t_pool.specs] \
            == [(s.name, tuple(s.shape), s.offset, s.size)
                for s in j_pool.specs]
        assert (t_pool.size, t_pool.padding) == (j_pool.size, j_pool.padding)
    # Model 3: both packages refuse the same configurations, with the
    # same message.
    j3, t3 = _localize(j_sh, j_specs, rules, 3), \
        _localize(t_sh, t_specs, rules, 3)
    assert isinstance(j3, str) == isinstance(t3, str)
    if isinstance(j3, str):
        assert t3 == j3
    else:
        assert _specs(t3) == _specs(j3)


def test_shard_and_unshard_round_trip():
    cfg, rules = get_smoke("qwen3-32b")
    specs = t_build(cfg).param_specs()
    rng = np.random.default_rng(0)
    full = t_params.map_specs(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), specs)
    parts = [convert.shard_params(full, rules, 2, r, specs=specs)
             for r in range(2)]
    local = t_sh.localize_specs(specs, rules, 2)
    for part in parts:
        assert [(n, a.shape) for n, a in sorted(_flat(part))] == \
            [(n, s) for n, s, _ in _specs(local)]
    # Rank 1 holds the second block of the vocabulary and of the heads.
    np.testing.assert_array_equal(parts[1]["embed"]["tokens"],
                                  full["embed"]["tokens"][128:])
    np.testing.assert_array_equal(parts[1]["layers"]["attn"]["wk"],
                                  full["layers"]["attn"]["wk"][..., 16:])
    np.testing.assert_array_equal(parts[1]["layers"]["attn"]["wo"],
                                  full["layers"]["attn"]["wo"][:, 64:])
    back = convert.unshard_params(parts, rules, specs=specs)
    for (n, a), (_, b) in zip(sorted(_flat(back)), sorted(_flat(full))):
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_mesh_topology_equals_jax():
    for shape in ((1, 1), (4, 2), (16, 16)):
        j_fake = types.SimpleNamespace(axis_names=("data", "model"),
                                       devices=np.empty(shape))
        t_m = t_mesh.Mesh(shape, t_mesh.AXES, 0, None, None)
        for axes in (("data",), ()):
            for j_fab, t_fab in ((None, None),
                                 ((j_cost.NCCL_56G,), (t_cost.NCCL_56G,))):
                want = j_mesh.mesh_topology(j_fake, axes, j_fab)
                got = t_mesh.mesh_topology(t_m, axes, t_fab)
                if want is None:
                    assert got is None
                    continue
                assert [(lv.axis, lv.size, lv.fabric.name,
                         lv.fabric.bw_peak, lv.fabric.alpha)
                        for lv in got.levels] == \
                    [(lv.axis, lv.size, lv.fabric.name, lv.fabric.bw_peak,
                      lv.fabric.alpha) for lv in want.levels]
    # One process, no group: the (1, 1) mesh, JAX's host mesh.
    host = t_mesh.make_host_mesh()
    assert host.devices.shape == j_mesh.make_host_mesh().devices.shape
    assert (host.num_data, host.model_size, host.data_index,
            host.model_index) == (1, 1, 0, 0)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        t_mesh.make_mesh((1, 2))
    # Three axes are JAX's ('pod', 'data', 'model'); other names refuse.
    pod = t_mesh.make_mesh((1, 1, 1), ("pod", "data", "model"))
    assert (pod.axis_names, pod.data_axes, pod.num_data) == (
        ("pod", "data", "model"), ("pod", "data"), 1)
    with pytest.raises(ValueError, match="has axes"):
        t_mesh.make_mesh((1, 1), ("pod", "model"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_local_specs_equal_jax(arch):
    """Each smoke configuration's local specs at model 2, the ones the
    CPU tests train under a model axis, are JAX's ``localize_specs``."""
    cfg, rules = get_smoke(arch)
    j_loc = j_sh.localize_specs(j_build(j_get_smoke(arch)[0]).param_specs(),
                                rules, 2)
    t_loc = t_sh.localize_specs(t_build(cfg).param_specs(), rules, 2)
    assert _specs(t_loc) == _specs(j_loc)


@pytest.mark.parametrize("arch,leaves", [
    ("arctic-480b", ("layers/ffn/wi_gate", "layers/ffn/wo")),
    ("grok-1-314b", ("layers/ffn/wi_up", "layers/ffn/wo")),
    ("musicgen-large", ("embed/codebooks", "head/w")),
    ("falcon-mamba-7b", ("layers/mixer/in_proj", "layers/mixer/x_proj")),
    ("zamba2-2.7b", ("mamba_layers/mixer/conv_w",
                     "mamba_layers/mixer/out_proj"))])
def test_family_shard_round_trip_is_bitwise(arch, leaves):
    """JAX's global leaves (an f32 tree from its initialiser) cut into
    the two ranks' local leaves and joined back, bit for bit; the named
    expert, codebook and inner-width leaves are the blocks along the
    dimension the rules put on the model axis."""
    cfg, rules = get_smoke(arch)
    full = jax.tree_util.tree_map(np.asarray, j_sh.init_params(
        j_build(j_get_smoke(arch)[0]).param_specs(), jax.random.PRNGKey(0)))
    specs = t_build(cfg).param_specs()
    parts = [convert.shard_params(full, rules, 2, r, specs=specs)
             for r in range(2)]
    flat_specs = dict(_flat(specs))
    flat_full = dict(_flat(full))
    for name in leaves:
        dim = t_sh.model_dim(flat_specs[name], rules)
        assert dim is not None, name
        n = flat_full[name].shape[dim] // 2
        for r, part in enumerate(parts):
            np.testing.assert_array_equal(
                dict(_flat(part))[name],
                np.take(flat_full[name], np.arange(r * n, (r + 1) * n),
                        axis=dim), err_msg=name)
    back = dict(_flat(convert.unshard_params(parts, rules, specs=specs)))
    assert back.keys() == flat_full.keys()
    for name, a in flat_full.items():
        assert back[name].dtype == a.dtype
        np.testing.assert_array_equal(back[name], a, err_msg=name)
