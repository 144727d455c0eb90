"""The port's DedupCheckpointer held against ``repro.checkpoint``.

Same trees (made from seeded numpy) through both packages on the CPU: the
same leaf keys, object names, stored bytes, ref-only decisions and launch
accounting, and a checkpoint written by either package restores in the
other. Everything compared is bytes or integers: tolerance 0.
"""

import collections
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

import repro.core as jcore
import repro_torch.core as tcore
from repro.checkpoint import CheckpointConfig as JConfig
from repro.checkpoint import DedupCheckpointer as JCheckpointer
from repro_torch.checkpoint import CheckpointConfig, DedupCheckpointer
from repro_torch.checkpoint.dedup_ckpt import _leaf_paths

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the full-size run: its tree layout)


def _small_tree() -> dict:
    """tests/test_cdc_checkpoint.py's tree, as host arrays."""
    return {
        "w": np.arange(12_000, dtype=np.float32),
        "b": np.full((257,), 0x3F80, np.uint16),  # bf16 ones
        "step": 3,
        "emb": np.arange(5_000, dtype=np.int32),
    }


def _to_torch(tree):
    def conv(x):
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(x.copy())
            return t.view(torch.bfloat16) if x.dtype == np.uint16 else t
        return x
    return _map(tree, conv)


def _to_jax(tree):
    def conv(x):
        if isinstance(x, np.ndarray):
            a = jnp.asarray(x)
            return a.view(jnp.bfloat16) if x.dtype == np.uint16 else a
        return x
    return _map(tree, conv)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _layer_tree(seed: int) -> dict:
    """A narrow decoder layer laid out as the full-size run lays it out."""
    shapes = chip_smoke.decoder_layer_shapes(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=192, qkv_bias=True
    )
    rng = np.random.default_rng(seed)
    return chip_smoke.materialize(
        shapes, lambda s: rng.integers(0, 2**16, size=s, dtype=np.uint16)
    )


def _host_tree(seed: int) -> dict:
    """The tree every JAX-side save here uses (one shape set, so the JAX
    package compiles its fused wave once per process)."""
    return {"small": _small_tree(), "layer": _layer_tree(seed)}


def _stored(cluster, manifest) -> list[tuple[str, bytes]]:
    names = [e["object"] for e in manifest["leaves"]]
    return [(n, cluster.read_object(n)) for n in names]


_CFG = dict(fp_chunk_bytes=4096, device_cdc=True)


def test_one_launch_pair_per_save_and_ref_only_resave():
    cluster = tcore.DedupCluster.create(3, chunking=tcore.ChunkingSpec("fixed", 16 * 1024))
    ckpt = DedupCheckpointer(cluster, CheckpointConfig(**_CFG), device="cpu")
    tree = _to_torch(_small_tree())
    assert ckpt.stats["cdc_launches"] == 0 and ckpt.stats["fp_launches"] == 0
    ckpt.save("s1", tree)
    assert (ckpt.stats["cdc_launches"], ckpt.stats["fp_launches"]) == (1, 1)
    ckpt.save("s2", tree)
    assert (ckpt.stats["cdc_launches"], ckpt.stats["fp_launches"]) == (2, 2)
    assert ckpt.stats["leaves_ref_only"] == 3
    # the fixed-size route books exactly one fingerprint launch
    ckpt2 = DedupCheckpointer(
        cluster, CheckpointConfig(fp_chunk_bytes=4096, device_cdc=False), device="cpu"
    )
    ckpt2.save("s3", tree)
    assert (ckpt2.stats["cdc_launches"], ckpt2.stats["fp_launches"]) == (0, 1)
    assert ckpt.list_checkpoints() == ["s1", "s2", "s3"]


@pytest.mark.parametrize("device_cdc", [True, False])
def test_keys_names_and_stored_bytes_match_reference(device_cdc):
    cfg = dict(fp_chunk_bytes=4096, device_cdc=device_cdc)
    host = _host_tree(1)
    tc = tcore.DedupCluster.create(3, chunking=tcore.ChunkingSpec("fixed", 16 * 1024))
    jc = jcore.DedupCluster.create(3, chunking=jcore.ChunkingSpec("fixed", 16 * 1024))
    tck = DedupCheckpointer(tc, CheckpointConfig(**cfg), device="cpu")
    jck = JCheckpointer(jc, JConfig(**cfg))
    tt, jt = _to_torch(host), _to_jax(host)
    for name in ("a", "b"):
        tm, jm = tck.save(name, tt), jck.save(name, jt)
        assert tm == jm
        assert _stored(tc, tm) == _stored(jc, jm)
    assert tck.stats == jck.stats


@pytest.mark.parametrize("device_cdc", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8])
def test_numpy_leaves_take_the_device_path_as_in_reference(dtype, device_cdc):
    """A numpy leaf saved twice is written once and then by reference, in
    both packages: its device fingerprint names it as a tensor's would."""
    leaf = (np.arange(40_000) % (256 if dtype == np.uint8 else 40_000)).astype(dtype)
    cfg = dict(fp_chunk_bytes=4096, device_cdc=device_cdc)
    tc = tcore.DedupCluster.create(3, chunking=tcore.ChunkingSpec("fixed", 16 * 1024))
    jc = jcore.DedupCluster.create(3, chunking=jcore.ChunkingSpec("fixed", 16 * 1024))
    tck = DedupCheckpointer(tc, CheckpointConfig(**cfg), device="cpu")
    jck = JCheckpointer(jc, JConfig(**cfg))
    for name in ("a", "b"):
        tm, jm = tck.save(name, {"w": leaf}), jck.save(name, {"w": leaf})
        assert tm == jm
        assert _stored(tc, tm) == _stored(jc, jm)
    header = 4 + len(json.dumps({"dtype": np.dtype(dtype).name, "shape": [40_000]}))
    assert tck.stats == jck.stats
    assert tck.stats["leaves_written"] == 1 and tck.stats["leaves_ref_only"] == 1
    assert tck.stats["bytes_sent"] == header + leaf.nbytes
    assert (tck.stats["cdc_launches"], tck.stats["fp_launches"]) == (2 if device_cdc else 0, 2)
    if dtype == np.float32:
        assert tck.stats["bytes_sent"] == 160_042


def test_numpy_leaves_torch_cannot_hold_are_written_in_full():
    cluster = tcore.DedupCluster.create(3)
    ckpt = DedupCheckpointer(cluster, CheckpointConfig(**_CFG), device="cpu")
    tree = {"names": np.array(["a", "bc"]), "w": np.arange(10, dtype=np.float32)}
    for name in ("a", "b"):
        ckpt.save(name, tree)
    assert ckpt.stats["leaves_written"] == 3 and ckpt.stats["leaves_ref_only"] == 1
    assert (ckpt.stats["cdc_launches"], ckpt.stats["fp_launches"]) == (2, 2)


def test_leaf_keys_spell_what_jax_spells():
    host = {
        "z": [np.arange(3, dtype=np.int32), None, (np.ones(2, np.float32), {"b": 1, "a": 2})],
        "layer": _layer_tree(0),
        7: np.zeros(4, np.int32),
        "": 5,
    }
    del host[7]  # JAX cannot sort mixed key types either
    assert [k for k, _ in _leaf_paths(_to_torch(host))] == [
        "/".join(str(p) for p in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(_to_jax(host))[0]
    ]


_Pair = collections.namedtuple("_Pair", ["second", "first"])


def _bf16_leaf() -> np.ndarray:
    return np.arange(40_000, dtype=np.float32).astype(jnp.bfloat16)


def _tree_parity(make_tree):
    """Save ``make_tree()`` twice through both checkpointers (the cluster
    of ``test_numpy_leaves_take_the_device_path_as_in_reference``) and hold
    the port to the reference: leaf keys, MANIFEST bytes, stored bytes,
    written / ref-only counts, bytes sent, launches, and the type and
    values ``restore(like=...)`` returns. Returns the port's stats."""
    tc = tcore.DedupCluster.create(3, chunking=tcore.ChunkingSpec("fixed", 16 * 1024))
    jc = jcore.DedupCluster.create(3, chunking=jcore.ChunkingSpec("fixed", 16 * 1024))
    tck = DedupCheckpointer(tc, CheckpointConfig(**_CFG), device="cpu")
    jck = JCheckpointer(jc, JConfig(**_CFG))
    tree = make_tree()
    assert [k for k, _ in _leaf_paths(tree)] == [
        "/".join(str(p) for p in path) for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]
    ]
    for name in ("a", "b"):
        tm, jm = tck.save(name, make_tree()), jck.save(name, make_tree())
        assert tm == jm
        mname = f"ckpt/{name}/MANIFEST"
        assert tc.read_object(mname) == jc.read_object(mname)
        assert _stored(tc, tm) == _stored(jc, jm)
    assert tck.stats == jck.stats
    tback, jback = tck.restore("b", like=tree), jck.restore("b", like=tree)
    assert jax.tree_util.tree_structure(jback) == jax.tree_util.tree_structure(tree)
    _same_containers(tback, jback)
    for (tk, tv), (jk, jv) in zip(_leaf_paths(tback), _leaf_paths(jback)):
        assert tk == jk
        want = np.asarray(jv)
        got = tv.view(torch.uint16).numpy() if tv.dtype == torch.bfloat16 else tv.numpy()
        np.testing.assert_array_equal(got, want.view(np.uint16) if want.dtype.name == "bfloat16" else want)
    return tck.stats


def _same_containers(a, b):
    assert type(a) is type(b) or (isinstance(a, torch.Tensor) and not isinstance(b, (dict, list, tuple)))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_containers(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_containers(x, y)


def test_numpy_bfloat16_leaf_takes_the_device_path_as_in_reference():
    """ROADMAP C1: a numpy bfloat16 leaf (``ml_dtypes``, kind "V") is
    written once and then by reference, as the reference does."""
    stats = _tree_parity(lambda: {"w": _bf16_leaf()})
    assert (stats["leaves_written"], stats["leaves_ref_only"]) == (1, 1)
    assert stats["bytes_sent"] == 80_043
    assert (stats["cdc_launches"], stats["fp_launches"]) == (2, 2)


def test_namedtuple_tree_keys_and_restore_match_reference():
    """ROADMAP C2: a namedtuple's fields are keyed ``.name`` and it is
    rebuilt as its own type, in save and in ``restore(like=...)``."""
    stats = _tree_parity(lambda: {
        "pair": _Pair(np.arange(300, dtype=np.int32), _Pair(np.ones(7, np.float32), _bf16_leaf()[:9])),
        "w": np.arange(50, dtype=np.float32),
    })
    assert (stats["leaves_written"], stats["leaves_ref_only"]) == (4, 4)


def test_ordered_dict_keeps_its_order_as_in_reference():
    """ROADMAP C3: an ``OrderedDict`` is walked in its own order (leaf keys,
    MANIFEST bytes) and restored as an ``OrderedDict``; a plain dict inside
    it is still sorted."""
    stats = _tree_parity(lambda: collections.OrderedDict(
        z=np.arange(20, dtype=np.float32),
        a={"y": np.ones(3, np.int32), "b": np.zeros(5, np.uint8)},
        m=collections.OrderedDict(q=np.full(4, 2, np.int32), c=np.arange(6, dtype=np.float32)),
    ))
    assert (stats["leaves_written"], stats["leaves_ref_only"]) == (5, 5)


def test_layer_save_resave_perturb_restore_matches_reference():
    """The slice as a whole on a narrow layer: s1 writes all 13 layer
    leaves, s2 refs all 13, s3 after touching the three FFN leaves writes 3
    and refs 10, and restore returns the tree; the JAX package decides the
    same."""
    host = _host_tree(2)
    tc = tcore.DedupCluster.create(4, replicas=2, chunking=tcore.ChunkingSpec("fixed", 8 * 1024))
    jc = jcore.DedupCluster.create(4, replicas=2, chunking=jcore.ChunkingSpec("fixed", 8 * 1024))
    tck = DedupCheckpointer(tc, CheckpointConfig(**_CFG), device="cpu")
    jck = JCheckpointer(jc, JConfig(**_CFG))
    tt, jt = _to_torch(host), _to_jax(host)
    ms = []
    for name in ("s1", "s2", "s3"):
        if name == "s3":
            for k in ("gate", "up", "down"):
                host["layer"]["blocks"][0]["ffn"][k]["w"][0, 0, :3] ^= 1
            tt, jt = _to_torch(host), _to_jax(host)
        tm, jm = tck.save(name, tt), jck.save(name, jt)
        assert tm == jm
        ms.append(tm)
    layer = [[e for e in m["leaves"] if e["key"].startswith("['layer']")] for m in ms]
    assert [len(m) for m in layer] == [13, 13, 13]
    assert [sum(e["ref"] for e in m) for m in layer] == [0, 13, 10]
    assert tck.stats == jck.stats
    back = tck.restore("s3", like=tt)
    for (k, a), (k2, b) in zip(_leaf_paths(tt), _leaf_paths(back)):
        assert k == k2
        if isinstance(a, torch.Tensor):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        else:
            assert int(b) == a


def test_cross_restore_both_ways():
    host = _host_tree(3)
    # JAX package writes, the port restores.
    jc = jcore.DedupCluster.create(3, chunking=jcore.ChunkingSpec("fixed", 16 * 1024))
    JCheckpointer(jc, JConfig(**_CFG)).save("j", _to_jax(host))
    back = DedupCheckpointer(jc, CheckpointConfig(**_CFG), device="cpu").restore("j")
    exp = {k: v for k, v in _leaf_paths(_to_torch(host))}
    assert sorted(back) == sorted(exp)
    for k, v in exp.items():
        if isinstance(v, torch.Tensor):
            assert back[k].dtype == v.dtype and torch.equal(back[k].view(torch.uint8), v.view(torch.uint8))
        else:
            assert int(back[k]) == v
    # The port writes, the JAX package restores.
    tc = tcore.DedupCluster.create(3, chunking=tcore.ChunkingSpec("fixed", 16 * 1024))
    DedupCheckpointer(tc, CheckpointConfig(**_CFG), device="cpu").save("t", _to_torch(host))
    jback = JCheckpointer(tc, JConfig(**_CFG)).restore("t")
    for k, v in exp.items():
        got = np.asarray(jback[k])
        if isinstance(v, torch.Tensor):
            want = v.view(torch.uint16).numpy() if v.dtype == torch.bfloat16 else v.numpy()
            got = got.view(np.uint16) if v.dtype == torch.bfloat16 else got
            np.testing.assert_array_equal(got, want)
        else:
            assert int(got) == v


def test_restore_like_rebuilds_the_tree():
    cluster = tcore.DedupCluster.create(3)
    ckpt = DedupCheckpointer(cluster, CheckpointConfig(**_CFG), device="cpu")
    tree = _to_torch({"layer": _layer_tree(4), "step": 7})
    ckpt.save("s", tree)
    back = ckpt.restore("s", like=tree)
    assert isinstance(back["layer"]["blocks"], tuple) and back["layer"]["tail"] == ()
    assert int(back["step"]) == 7
    ckpt.delete("s")
    with pytest.raises(tcore.ReadError):
        ckpt.restore("s")


def test_checkpointer_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError):
        DedupCheckpointer(tcore.DedupCluster.create(3))
