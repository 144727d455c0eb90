"""The port's sharding rules and specs held against ``repro.distributed``
and ``repro.launch.specs``.

Twins of every test in ``tests/test_sharding.py`` on the port, then the
specs of both packages side by side: the parameter specs of every arch of
the JAX package's registry at full width (divisibility by 16 decides them) on both
production meshes, and for every ``SHAPES`` entry the rules, the batch
shardings and the cache shardings. The JAX side runs in a subprocess with
512 host devices and ``Auto`` meshes (``repro.launch.mesh`` builds
``Explicit`` ones under JAX 0.9, on which the reference's ``shard``
asserts); the port side in a subprocess that makes the meshes with
``repro_torch.launch.mesh.make_production_mesh`` on a ``fake`` process
group. Specs are compared entry by entry: tolerance 0.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)

from repro_torch.distributed.sharding import (
    PartitionSpec as P,
    ShardingRules,
    infer_param_spec,
    make_rules,
    param_specs_for_tree,
    placements,
    shard,
    use_sharding_rules,
)

ROOT = Path(__file__).resolve().parents[1]
AX = {"pod": 2, "data": 16, "model": 16}


def rules():
    return ShardingRules(make_rules().rules, AX)


# ------------------------------------------------- twins of test_sharding --
def test_embed_table_spec():
    s = infer_param_spec(("embed", "table"), (152064, 5120), rules())
    assert s == P("model", "data")


def test_embed_table_indivisible_vocab_guard():
    s = infer_param_spec(("embed", "table"), (50280, 2048), rules())
    assert s == P(None, "data")


def test_up_and_down_proj_specs():
    up = infer_param_spec(("blocks", "0", "attn", "wq", "w"), (64, 5120, 5120), rules())
    assert up == P(None, "data", "model")
    down = infer_param_spec(("blocks", "0", "attn", "wo", "w"), (64, 5120, 5120), rules())
    assert down == P(None, "model", "data")


def test_expert_specs():
    g = infer_param_spec(("blocks", "0", "moe", "experts", "gate"), (48, 16, 5120, 8192), rules())
    assert g == P(None, "model", "data", None)
    d = infer_param_spec(("blocks", "0", "moe", "experts", "down"), (48, 16, 8192, 5120), rules())
    assert d == P(None, "model", None, "data")


def test_indivisible_experts_guard():
    g = infer_param_spec(("moe", "experts", "gate"), (60, 2048, 1408), rules())
    assert g == P(None, "data", None)  # 60 % 16 != 0 -> replicate experts


def test_norm_replicated():
    s = infer_param_spec(("blocks", "0", "norm1", "scale"), (64, 5120), rules())
    assert s == P(None, None)


def test_bias_spec():
    s = infer_param_spec(("attn", "wq", "b"), (5120,), rules())
    assert s == P("model")


def test_activation_guard_drops_indivisible():
    r = rules()
    with use_sharding_rules(r):
        # 6 heads % 16 != 0 -> constraint dropped, no error
        x = torch.zeros((2, 8, 6, 64))
        y = shard(x, "batch", "seq", "act_heads", None)
        assert y.shape == x.shape and y is x


def test_param_specs_for_tree_covers_whole_model():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("qwen2-moe-a2.7b").reduced()
    m = build_model(cfg, device="cpu")
    specs = param_specs_for_tree(m.param_specs(), rules())
    leaves = _spec_leaves(specs)
    assert leaves and all(isinstance(s, P) for s in leaves)


def test_rules_decode_overrides():
    r = make_rules(kv_seq_axis="model")
    assert r.axis("kv_seq") == "model"
    r2 = make_rules(data_axes=None, kv_seq_axis=("data", "model"))
    assert r2.axis("batch") is None


def _spec_leaves(tree) -> list:
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _spec_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _spec_leaves(v)]
    return []


# ------------------------------------------------- placements and shard() --
class _Mesh:
    """Names and sizes of a mesh: all ``placements`` reads."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)


@pytest.mark.parametrize(
    "spec, names, want",
    [
        (P(("pod", "data"), None, None), ("pod", "data", "model"), ("S0", "S0", "R")),
        (P(None, "data", "model"), ("data", "model"), ("S1", "S2")),
        (P("model", "data"), ("data", "model"), ("S1", "S0")),
        (P(None, ("data", "model")), ("data", "model"), ("S1", "S1")),
        (P(None, None), ("data", "model"), ("R", "R")),
    ],
)
def test_placements_one_per_mesh_dim_major_to_minor(spec, names, want):
    got = placements(spec, _Mesh(names, [2] * len(names)))
    assert tuple("R" if p.is_replicate() else f"S{p.dim}" for p in got) == want


@pytest.mark.parametrize("spec", [P(("model", "data")), P("pod"), P("data", "data")])
def test_placements_raise_for_what_a_mesh_cannot_place(spec):
    with pytest.raises(ValueError):
        placements(spec, _Mesh(("data", "model"), (2, 2)))


def test_shard_redistributes_a_dtensor_and_leaves_plain_tensors():
    """On a world-1 gloo group: ``shard`` places a DTensor as the rules say
    (values unchanged), is the identity without rules, and the model
    helpers are the plain operations on plain tensors."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import specs as SP

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        x = torch.arange(2 * 8 * 6 * 4, dtype=torch.float32).reshape(2, 8, 6, 4)
        dx = DTensor.from_local(x, mesh, [Replicate(), Replicate()])
        assert shard(dx, "batch", "seq", "act_heads", None) is dx  # no rules
        from repro_torch.configs.base import SHAPES

        r = SP.rules_for(mesh, SHAPES["prefill_32k"])
        assert r.axis_sizes == {"data": 1, "model": 1}
        with use_sharding_rules(r):
            y = shard(dx, "batch", "seq", "act_heads", None)
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert torch.equal(y.full_tensor(), x)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ both packages' specs ----
_JAX_SIDE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.configs import ARCHS, SHAPES, get_config
    from repro.distributed.sharding import param_specs_for_tree
    from repro.launch import specs as SP
    from repro.models import build_model

    def entry(a):
        return a if a is None or isinstance(a, str) else list(a)

    def flat(tree):
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P) or hasattr(x, "spec"))[0]:
            spec = leaf.spec if hasattr(leaf, "spec") else leaf
            keys = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            out[keys] = [entry(a) for a in spec]
        return out

    res = {}
    for tag, shape, axes in (("pod16x16", (16, 16), ("data", "model")),
                             ("pod2x16x16", (2, 16, 16), ("pod", "data", "model"))):
        mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))
        for arch in ARCHS:
            model = build_model(get_config(arch))
            tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
            for sname, s in SHAPES.items():
                rules = SP.rules_for(mesh, s)
                key = f"{tag}|{arch}|{sname}"
                res[key] = {
                    "rules": {k: entry(v) for k, v in rules.rules.items()},
                    "axis_sizes": rules.axis_sizes,
                    "params": flat(param_specs_for_tree(tree, rules)),
                    "batch": flat(SP.batch_shardings(mesh, rules, model.input_specs(s))),
                    "cache": flat(SP.cache_shardings(mesh, rules, model.cache_specs(s))),
                }
    json.dump(res, sys.stdout)
""")

_PORT_SIDE = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import PartitionSpec as P, param_specs_for_tree
    from repro_torch.launch import dryrun, specs as SP
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model

    multi_pod = sys.argv[1] == "pod2x16x16"
    dryrun.start_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)

    def entry(a):
        return a if a is None or isinstance(a, str) else list(a)

    def flat(tree, path=()):
        if isinstance(tree, (P, SP.NamedSharding)):
            spec = tree.spec if isinstance(tree, SP.NamedSharding) else tree
            if isinstance(tree, SP.NamedSharding):
                tree.placements  # every spec places on its mesh
            return {"/".join(path): [entry(a) for a in spec]}
        out = {}
        if isinstance(tree, dict):
            for k, v in tree.items():
                out.update(flat(v, (*path, str(k))))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                out.update(flat(v, (*path, str(i))))
        return out

    res = {}
    for arch in sys.argv[2].split(","):  # the archs the JAX package has too
        model = build_model(get_config(arch), device="cpu")
        tree = model.param_specs()
        for sname, s in SHAPES.items():
            rules = SP.rules_for(mesh, s)
            res[f"{sys.argv[1]}|{arch}|{sname}"] = {
                "rules": {k: entry(v) for k, v in rules.rules.items()},
                "axis_sizes": rules.axis_sizes,
                "params": flat(SP.param_shardings(mesh, rules, tree)),
                "batch": flat(SP.batch_shardings(mesh, rules, model.input_specs(s))),
                "cache": flat(SP.cache_shardings(mesh, rules, model.cache_specs(s))),
            }
    json.dump(res, sys.stdout)
""")


def _run(code: str, *args: str) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code, *args], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout)


@pytest.fixture(scope="module")
def both_sides():
    pytest.importorskip("jax")
    from repro.configs import ARCHS

    port = {}
    for tag in ("pod16x16", "pod2x16x16"):
        port.update(_run(_PORT_SIDE, tag, ",".join(ARCHS)))
    return _run(_JAX_SIDE), port


def _cells(side: dict, part: str):
    return {k: v[part] for k, v in side.items()}


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_param_specs_of_every_arch_at_full_width_equal_reference(both_sides, mesh):
    ref, port = both_sides
    keys = [k for k in ref if k.startswith(mesh + "|")]
    assert len(keys) == 10 * 4 and set(keys) == {k for k in port if k.startswith(mesh + "|")}
    for k in keys:
        assert port[k]["params"] == ref[k]["params"], k


@pytest.mark.parametrize("part", ["rules", "axis_sizes", "batch", "cache"])
def test_rules_batch_and_cache_shardings_of_every_shape_equal_reference(both_sides, part):
    ref, port = both_sides
    assert _cells(port, part) == _cells(ref, part)
