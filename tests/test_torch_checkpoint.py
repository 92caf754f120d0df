"""Checkpoints through the version store: the port against the JAX package.

A checkpoint that either package writes restores bit for bit in the other;
for the same values both write the same annex keys and the same checkpoint
subtree; the port's chunk cutter gives the reference's chunks; and serving
from a JAX-saved checkpoint gives JAX's greedy tokens exactly (fp32, smoke
sizes).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.chunks import ChunkParams as JChunkParams  # noqa: E402
from repro.core.chunks import cut_bytes  # noqa: E402
from repro.core.repo import Repository as JRepository  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.optim.adamw import AdamW  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.train.steps import greedy_decode as jax_greedy_decode  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.chunks import ChunkParams, Cutter  # noqa: E402
from repro_torch.core.hashing import chunk_key_for_bytes  # noqa: E402
from repro_torch.core.repo import Repository  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager, _flatten  # noqa: E402

ARCH = "qwen3_0_6b"
SMALL_CHUNKS = dict(chunk_threshold=4096, chunk_params={"min_size": 512, "avg_bits": 10, "max_size": 4096})


def _jax_state(dtype):
    """The qwen3 smoke params and their AdamW state (fp32 moments, a 0-d
    int32 step), as numpy arrays."""
    params = jax_init_params(JT.param_defs(jconfigs.get_smoke(ARCH)), seed=0, dtype=dtype)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, AdamW().init(params))


def _bits(a):
    """A leaf's dtype name, shape and bytes (bf16 as its bits), numpy or torch."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()
        return ("bfloat16" if a.dtype == np.uint16 else a.dtype.name), a.shape, a.tobytes()
    a = np.asarray(a)
    name = a.dtype.name
    return name, a.shape, (a.view(np.uint16) if name == "bfloat16" else a).tobytes()


def _assert_bit_equal(got: dict, want: dict):
    got, want = _flatten(got), _flatten(want)
    assert sorted(got) == sorted(want)
    for path in want:
        assert _bits(got[path]) == _bits(want[path]), path


def _legacy(jrepo, oid):
    """Rewrite a JAX checkpoint as a pre-key one: every leaf file holds its
    npy bytes (small ones become inline blobs) and the manifest names no key."""
    ckpt = JCheckpointManager(jrepo)
    reldir = "checkpoints/step_00000001"
    manifest = json.loads(ckpt._tree_bytes(oid, f"{reldir}/manifest.json"))
    for meta in manifest["leaves"].values():
        data = jrepo.annex.read(meta.pop("key"))
        meta.pop("chunked")
        with open(os.path.join(jrepo.root, reldir, meta["file"]), "wb") as f:
            f.write(data)
    with open(os.path.join(jrepo.root, reldir, "manifest.json"), "wb") as f:
        f.write(json.dumps(manifest, indent=1, sort_keys=True).encode())
    message = jrepo.objects.get_commit(oid)["message"]
    new = jrepo.save(paths=[reldir], message=message)
    kinds = {jrepo.entry_at(new, f"{reldir}/{m['file']}")["t"] for m in manifest["leaves"].values()}
    assert kinds == {"blob", "annex"}
    return new


@pytest.mark.parametrize("case", ["bfloat16", "float32", "chunked", "repacked", "legacy"])
def test_jax_checkpoint_restores_bit_for_bit_in_the_port(tmp_path, case):
    params, opt_state = _jax_state(jnp.float32 if case == "float32" else jnp.bfloat16)
    jrepo = JRepository.init(str(tmp_path), **(SMALL_CHUNKS if case == "chunked" else {}))
    oid = JCheckpointManager(jrepo).save(1, params, opt_state, data_step=7)
    if case == "chunked":
        assert any(e.get("chunked") for e in jrepo.tree_of(oid).values())
    if case == "repacked":
        assert jrepo.objects.repack()["objects_packed"] > 0
        shards = [os.path.join(jrepo.objects.root, d) for d in os.listdir(jrepo.objects.root) if len(d) == 2]
        assert not any(os.listdir(d) for d in shards)  # no loose object left
    if case == "legacy":
        oid = _legacy(jrepo, oid)
    state, manifest = CheckpointManager(Repository(str(tmp_path))).restore(device="cpu")
    assert manifest["step"] == 1 and manifest["data_step"] == 7
    assert state["opt_state"]["step"].dim() == 0
    _assert_bit_equal(state, {"params": params, "opt_state": opt_state})


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("chunked", [False, True])
def test_port_checkpoint_restores_in_jax_with_the_same_keys_and_subtree(tmp_path, dtype, chunked):
    params, opt_state = _jax_state(getattr(jnp, dtype))
    tparams, topt = (params_from_numpy(t, device="cpu") for t in (params, opt_state))
    kw = SMALL_CHUNKS if chunked else {}
    repo = Repository.init(str(tmp_path / "port"), **kw)
    oid = CheckpointManager(repo).save(1, tparams, topt)
    jrepo = JRepository.init(str(tmp_path / "jax"), **kw)
    joid = JCheckpointManager(jrepo).save(1, params, opt_state)

    state, manifest = JCheckpointManager(JRepository(repo.root)).restore(oid)
    _assert_bit_equal(state, {"params": params, "opt_state": opt_state})
    _, jmanifest = JCheckpointManager(jrepo).restore(joid)
    assert manifest == jmanifest  # every leaf's annex key, shape and dtype name
    assert any(m["chunked"] for m in manifest["leaves"].values()) == chunked
    rel = "checkpoints/step_00000001"
    assert repo.entry_at(oid, rel) == jrepo.entry_at(joid, rel)
    commit, jcommit = repo.objects.get_commit(oid), jrepo.objects.get_commit(joid)
    assert commit["spec"] == jcommit["spec"]
    assert commit["message"].replace(repo.dsid, "") == jcommit["message"].replace(jrepo.dsid, "")


def test_a_subtree_restore_reads_only_that_part_of_a_jax_checkpoint(tmp_path, monkeypatch):
    """Serving restores ``params`` alone (``serve.run``'s params-only
    restore): the same tensors as the whole restore's, and no leaf of the
    moments is read."""
    params, opt_state = _jax_state(jnp.float32)
    oid = JCheckpointManager(JRepository.init(str(tmp_path))).save(1, params, opt_state)
    ckpt = CheckpointManager(Repository(str(tmp_path)))
    read = []
    plain_read = ckpt.repo.annex.read
    monkeypatch.setattr(ckpt.repo.annex, "read", lambda key: read.append(key) or plain_read(key))
    state, manifest = ckpt._restore(oid, "cpu", params_only=True)
    assert list(state) == ["params"] and manifest["step"] == 1
    _assert_bit_equal(state, {"params": params})
    params_keys = [m["key"] for p, m in manifest["leaves"].items() if p.startswith("params/")]
    assert sorted(read) == sorted(params_keys)  # one read a params leaf (identical leaves share a key)
    assert len(params_keys) < len(manifest["leaves"])


def test_port_repository_opens_in_jax(tmp_path):
    repo = Repository.init(str(tmp_path), chunk_threshold=1 << 20)
    jrepo = JRepository(str(tmp_path))
    assert jrepo.config == repo.config and jrepo.current_branch() == "main"
    assert jrepo._should_chunk(1 << 20) and jrepo.head_commit() is None
    (tmp_path / "d").mkdir()
    big = bytes(range(256)) * 400  # above the annex threshold, below the chunk threshold
    (tmp_path / "d" / "a.bin").write_bytes(big)
    (tmp_path / "d" / "b.txt").write_bytes(b"y" * 10)
    oid = repo.save(paths=["d"], message="m")
    assert jrepo.head_commit() == oid
    assert jrepo.tree_of(oid) == {"d/a.bin": {"t": "annex", "key": repo.entry_at(oid, "d/a.bin")["key"]},
                                  "d/b.txt": {"t": "blob", "oid": repo.entry_at(oid, "d/b.txt")["oid"]}}
    assert jrepo.annex.read(jrepo.tree_of(oid)["d/a.bin"]["key"]) == big


def test_port_stages_by_the_annex_patterns_of_a_jax_repository(tmp_path):
    """The port's init writes no patterns; it honours those of a JAX-made repository."""
    JRepository.init(str(tmp_path / "j"), annex_patterns=("*.bin",))
    JRepository.init(str(tmp_path / "p"), annex_patterns=("*.bin",))
    for root in ("j", "p"):
        (tmp_path / root / "d").mkdir()
        (tmp_path / root / "d" / "a.bin").write_bytes(b"x" * 10)
        (tmp_path / root / "d" / "b.txt").write_bytes(b"y" * 10)
    joid = JRepository(str(tmp_path / "j")).save(paths=["d"], message="m")
    repo = Repository(str(tmp_path / "p"))
    oid = repo.save(paths=["d"], message="m")
    assert repo.entry_at(oid, "d/a.bin")["t"] == "annex" and repo.entry_at(oid, "d/b.txt")["t"] == "blob"
    assert repo._tree_oid_of(oid) == JRepository(str(tmp_path / "j"))._tree_oid_of(joid)
    assert repo.annex.read(repo.entry_at(oid, "d/a.bin")["key"]) == b"x" * 10


def test_checkpoints_and_latest_answer_as_jax_and_from_the_cache(tmp_path, monkeypatch):
    repo = Repository.init(str(tmp_path))
    ckpt = CheckpointManager(repo)
    for step in (1, 2, 3):
        ckpt.save(step, {"w": torch.full((4,), float(step))}, {})
        assert ckpt.latest()[1] == step
    want = JCheckpointManager(JRepository(str(tmp_path))).checkpoints()
    assert ckpt.checkpoints() == want and [s for _, s in want] == [3, 2, 1]
    reads = []
    get_commit = repo.objects.get_commit
    monkeypatch.setattr(repo.objects, "get_commit", lambda oid: reads.append(oid) or get_commit(oid))
    assert ckpt.checkpoints() == want and ckpt.latest() == want[0]
    assert reads == []  # an unchanged tip answers from the cache
    ckpt.save(4, {"w": torch.zeros(4)}, {})
    reads.clear()
    assert [s for _, s in ckpt.checkpoints()] == [4, 3, 2, 1]
    assert len(reads) == 1  # only the new commit was walked


def test_resolve_takes_a_branch_a_full_oid_and_a_unique_prefix(tmp_path):
    repo = Repository.init(str(tmp_path))
    oid = CheckpointManager(repo).save(1, {"w": torch.ones(2)}, {})
    assert repo.resolve("main") == repo.resolve(oid) == repo.resolve(oid[:8]) == oid
    with pytest.raises(ValueError, match="cannot resolve"):
        repo.resolve("no_such_branch")
    state, _ = CheckpointManager(repo).restore(oid[:8], device="cpu")
    assert torch.equal(state["params"]["w"], torch.ones(2))


@pytest.mark.parametrize("params", [None, {"min_size": 256, "avg_bits": 9, "max_size": 2048}])
def test_cutter_cuts_the_same_chunks_as_the_reference(params):
    rng = np.random.default_rng(0)
    # random bytes, then a zero run (no candidate: the max-size fallback), then a short period
    data = bytes(rng.integers(0, 256, 2_000_000, dtype=np.uint8)) + bytes(2_500_000) + b"ab" * 20_000
    want = cut_bytes(data, JChunkParams(**params) if params else None)
    cutter = Cutter(ChunkParams(**params) if params else None)
    got, at, sizes = [], 0, [7_919, 511]  # blocks for the numpy scan and the Python one, in turn
    while at < len(data):
        got += cutter.feed(data[at : at + sizes[0]])
        at += sizes[0]
        sizes.reverse()
    got += cutter.finish()
    assert len(want) > 3 and b"".join(got) == data
    assert [chunk_key_for_bytes(c) for c in got] == [chunk_key_for_bytes(c) for c in want]


def test_a_key_that_is_not_local_raises_naming_the_roadmap(tmp_path):
    repo = Repository.init(str(tmp_path))
    ckpt = CheckpointManager(repo)
    oid = ckpt.save(1, {"w": torch.ones(100_000)}, {})
    key = repo.entry_at(oid, "checkpoints/step_00000001/params.w.npy")["key"]
    os.unlink(repo.annex._path(key))
    with pytest.raises(FileNotFoundError, match=r"ROADMAP.md §A item 2"):
        ckpt.restore(device="cpu")


def test_async_save_failure_is_reraised(tmp_path):
    """The port's tests/test_train.py::test_async_checkpoint_failure_is_reraised."""
    params = {"w": torch.ones(4)}
    opt_state = {"step": torch.tensor(0, dtype=torch.int32)}
    ckpt = CheckpointManager(Repository.init(str(tmp_path)))
    orig_write = ckpt._write

    def failing(*a, **k):
        raise RuntimeError("injected write failure")

    ckpt._write = failing
    ckpt.save_async(1, params, opt_state)
    with pytest.raises(RuntimeError, match="injected write failure"):
        ckpt.wait()
    ckpt.wait()  # consumed by the re-raise, not sticky
    ckpt.save_async(2, params, opt_state)
    with pytest.raises(RuntimeError, match="injected write failure"):
        ckpt.save_async(3, params, opt_state)
    ckpt._write = orig_write
    ckpt.save_async(4, params, opt_state)
    params["w"].add_(1)  # the snapshot was taken: a later change is not saved
    ckpt.wait()
    state, manifest = ckpt.restore(device="cpu")
    assert manifest["step"] == 4 and torch.equal(state["params"]["w"], torch.ones(4))


@pytest.mark.parametrize("arch,overrides", [
    ("qwen3_0_6b", None),
    ("rwkv6_1_6b", None),
    ("jamba_1_5_large_398b", {"moe": None}),
])
def test_serve_from_a_jax_checkpoint_gives_jax_greedy_tokens(tmp_path, arch, overrides):
    batch, prompt_len, gen = 2, 16, 4
    jcfg = jconfigs.get_smoke(arch).replace(**(overrides or {}))
    jparams = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    jrepo = JRepository.init(str(tmp_path))
    JCheckpointManager(jrepo).save(5, jparams, {})
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (batch, prompt_len))
    want = jax_greedy_decode(jcfg, None, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, gen,
                             prompt_len + gen)
    res = serve.run(arch, batch=batch, prompt_len=prompt_len, gen=gen, device="cpu",
                    dtype="float32", overrides=overrides, repo=str(tmp_path))
    assert res.checkpoint_step == 5
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(want))


def test_serve_main_restores_a_commit(tmp_path, capsys):
    cfg_params = jax_init_params(JT.param_defs(jconfigs.get_smoke(ARCH)), seed=1, dtype=jnp.float32)
    jrepo = JRepository.init(str(tmp_path))
    oid = JCheckpointManager(jrepo).save(2, cfg_params, {})
    JCheckpointManager(jrepo).save(3, jax.tree.map(jnp.zeros_like, cfg_params), {})
    res = serve.main(["--arch", ARCH, "--batch", "1", "--prompt-len", "8", "--gen", "2",
                      "--device", "cpu", "--repo", str(tmp_path), "--commit", oid[:10]])
    assert res.checkpoint_step == 2
    assert f"restored checkpoint step 2 from {tmp_path}" in capsys.readouterr().out


def test_serve_refuses_a_checkpoint_that_does_not_fit_the_config(tmp_path):
    jparams = jax_init_params(JT.param_defs(jconfigs.get_smoke(ARCH)), seed=0, dtype=jnp.float32)
    JCheckpointManager(JRepository.init(str(tmp_path))).save(1, jparams, {})
    n_layers = jconfigs.get_smoke(ARCH).n_layers
    with pytest.raises(ValueError, match="does not fit qwen3_0_6b's config"):
        serve.run(ARCH, batch=1, prompt_len=8, gen=2, device="cpu", repo=str(tmp_path),
                  overrides={"n_layers": n_layers - 1})


def test_serve_main_refuses_dtype_with_repo(tmp_path, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--device", "cpu", "--repo", str(tmp_path), "--dtype", "float32"])
    assert "--dtype is not used with --repo" in capsys.readouterr().err
