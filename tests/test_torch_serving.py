"""The port's server with cluster-wide KV prefix-cache dedup.

``tests/test_serving.py`` twinned on the port, then the two packages side by
side on the CPU: one request sequence through the JAX server and the port's,
with the same float32 weights, must reuse and compute the same tokens and
generate the same ones; a KV block payload written by either package reads
back exactly in the other.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers share the host's cores
    torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.core import ChunkingSpec as JChunkingSpec
from repro.core import DedupCluster as JDedupCluster
from repro.models import build_model as jbuild_model
from repro.serving import BatchedServer as JBatchedServer
from repro.serving import ServeConfig as JServeConfig
from repro.serving import server as jserver
from repro_torch.configs import get_config
from repro_torch.core import ChunkingSpec, DedupCluster
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import BatchedServer, KVBlockCache, ServeConfig
from repro_torch.serving import server as tserver

ARCH = "qwen2.5-32b"


@pytest.fixture(scope="module")
def server():
    m = build_model(get_config(ARCH).reduced(), device="cpu")
    cluster = DedupCluster.create(3, chunking=ChunkingSpec("fixed", 16 * 1024))
    return BatchedServer(m, m.init(0), cluster, ServeConfig(max_len=96, block_tokens=8))


def test_prefix_reuse_and_determinism(server):
    p = list(range(40, 72))
    r1 = server.handle(p, gen_tokens=4)
    r2 = server.handle(p + [9, 9], gen_tokens=4)
    r3 = server.handle(p, gen_tokens=4)
    assert r1["reused_tokens"] == 0
    assert r2["reused_tokens"] >= 32
    assert r3["reused_tokens"] == 24  # last block always recomputed
    assert r1["tokens"] == r3["tokens"], "cached-prefix decode must be deterministic"


def test_divergent_prefixes_do_not_cross_match(server):
    server.handle([1] * 32, gen_tokens=2)
    b = server.handle([2] * 32, gen_tokens=2)
    assert b["reused_tokens"] == 0


def test_chain_fingerprints_capture_position():
    kv = KVBlockCache(DedupCluster.create(2, chunking=ChunkingSpec("fixed", 4096)), block_tokens=4)
    fps_a = kv.block_fps([1, 2, 3, 4, 5, 6, 7, 8])
    fps_b = kv.block_fps([5, 6, 7, 8, 1, 2, 3, 4])
    assert fps_a[0] != fps_b[1], "same tokens at different prefix => different identity"


def test_eviction_respects_pins_and_reclaims_space(server):
    kv = server.kv
    before_unique = kv.cluster.unique_bytes_stored()
    server.handle(list(range(100, 132)), gen_tokens=2)
    assert kv.cluster.unique_bytes_stored() > 0
    assert kv.evict(0) > 0  # no pins held after handle() returns
    cl = kv.cluster
    cl.tick(20); cl.run_gc(); cl.tick(20); cl.run_gc()
    assert cl.unique_bytes_stored() <= before_unique + 1


def test_kv_identity_dedups_across_replicas():
    """Two serving replicas writing the same prefix block store it once."""
    cluster = DedupCluster.create(4, chunking=ChunkingSpec("fixed", 4096))
    kv1 = KVBlockCache(cluster, block_tokens=4)
    kv2 = KVBlockCache(cluster, block_tokens=4)
    payload = os.urandom(9000)
    fps1, fps2 = kv1.block_fps([1, 2, 3, 4]), kv2.block_fps([1, 2, 3, 4])
    assert fps1 == fps2
    kv1.put_blocks(fps1, [payload])
    kv2.put_blocks(fps2, [payload])
    assert cluster.unique_bytes_stored() == 9000
    n, _ = kv2.match_prefix([1, 2, 3, 4, 9, 9, 9, 9])
    assert n == 4


def test_block_fingerprints_equal_the_jax_package():
    from repro.serving import KVBlockCache as JKVBlockCache

    toks = [int(t) for t in np.random.default_rng(0).integers(0, 512, 40)]
    jkv = JKVBlockCache(JDedupCluster.create(2, chunking=JChunkingSpec("fixed", 4096)), block_tokens=8)
    tkv = KVBlockCache(DedupCluster.create(2, chunking=ChunkingSpec("fixed", 4096)), block_tokens=8)
    assert [fp.hex for fp in tkv.block_fps(toks)] == [fp.hex for fp in jkv.block_fps(toks)]


def _servers():
    """The JAX server and the port's on the same float32 weights."""
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), param_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), param_dtype=torch.float32)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tm = build_model(tcfg, device="cpu")
    kw = dict(max_len=112, block_tokens=8)
    js = JBatchedServer(jm, jp, JDedupCluster.create(4, chunking=JChunkingSpec("fixed", 64 * 1024)), JServeConfig(**kw))
    ts = BatchedServer(tm, params_from_numpy(tree, tcfg, device="cpu"), DedupCluster.create(4, chunking=ChunkingSpec("fixed", 64 * 1024)),
                       ServeConfig(**kw))
    return js, ts


def test_servers_agree_with_the_jax_package():
    """launch/serve.py's traffic (48 shared prefix tokens + 8 random ones,
    8 generated) plus a repeat of the first prompt, through both servers."""
    js, ts = _servers()
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(0, 512, 48)]
    prompts = [shared + [int(t) for t in rng.integers(0, 512, 8)] for _ in range(3)]
    prompts.append(prompts[0])
    for i, p in enumerate(prompts):
        a, b = js.handle(p, gen_tokens=8), ts.handle(p, gen_tokens=8)
        assert b == a, (i, a, b)
        assert b["reused_tokens"] == (0 if i == 0 else 48)
    assert dataclasses.asdict(ts.kv.stats) == dataclasses.asdict(js.kv.stats)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_kv_payloads_read_back_in_either_package(dtype):
    rng = np.random.default_rng(1)
    shape = (2, 1, 8, 2, 32)  # (G, B, block_tokens, K, hd)
    if dtype == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        jk, jv = (jnp.asarray(a).astype(dtype) for a in (k, v))
        tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (k, v))
    bits = lambda a: np.asarray(a).view(np.uint16) if np.asarray(a).dtype.name == "bfloat16" else np.asarray(a)
    tbits = lambda t: t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()
    # JAX writes, the port reads
    rk, rv = tserver._kv_from_bytes(jserver._kv_to_bytes(np.asarray(jk), np.asarray(jv)))
    assert rk.dtype == tk.dtype
    np.testing.assert_array_equal(tbits(rk), bits(jk))
    np.testing.assert_array_equal(tbits(rv), bits(jv))
    # the port writes, JAX reads
    bk, bv = jserver._kv_from_bytes(tserver._kv_to_bytes(tk, tv))
    assert bk.dtype == np.asarray(jk).dtype
    np.testing.assert_array_equal(bits(bk), tbits(tk))
    np.testing.assert_array_equal(bits(bv), tbits(tv))


def test_serve_launcher_prints_the_jax_lines(capsys, monkeypatch):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    flags = ["--arch", ARCH, "--requests", "3", "--gen-tokens", "4"]
    monkeypatch.setattr("sys.argv", ["serve", *flags])
    jserve.main()
    want = capsys.readouterr().out
    tserve.main([*flags, "--device", "cpu"])
    assert capsys.readouterr().out == want
    # --dryrun re-execs the port's dry run as the reference re-execs its
    # own, at --shape (default decode_32k); the run itself is
    # tests/test_torch_dryrun.py's
    calls = []
    monkeypatch.setattr("subprocess.call", lambda cmd, env=None: calls.append(cmd) or 0)
    for extra, want_shape in (([], "decode_32k"), (["--shape", "long_500k"], "long_500k")):
        with pytest.raises(SystemExit) as exit_:
            tserve.main([*flags, "--dryrun", *extra])
        assert exit_.value.code == 0
        assert calls.pop()[1:] == ["-m", "repro_torch.launch.dryrun", "--arch", flags[1],
                                   "--shape", want_shape, "--force"]
