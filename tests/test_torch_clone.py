"""The port's clone, checkout and switch (``repro_torch.core.repo``) against
``repro.core``. Neither side imports jax; jobs are tiny bash scripts.

- ``tests/test_core_vcs.py``'s save/checkout roundtrip, the job branches
  made with ``switch`` and merged in an octopus, the octopus conflict, and
  the clone without annexed content, each run by both packages.
- A repository made by either package cloned by either (with the source
  repacked or not): the same dsid, refs, HEAD and objects, the origin's
  annex as ``remote0``, pointers in the worktree until ``annex_get``, and
  the other package reads, verifies and checks out the clone.
- A clone of a repacked repository: no loose object, every tree and blob
  read from the copied packs.
- The clone carries the remote sites and ``numcopies``.
- A clone by each package of copies of one repository on GPFS charges the
  same ``SimClock`` counters but for the port's publication through a tmp
  and a rename: two metadata operations more for each file it copies (every
  object file, every ref, HEAD), each config save and each worktree file;
  a ``switch`` likewise, two more for HEAD and for each worktree file.
- ``checkout(paths=)`` and the octopus merge write the same files in both.
- ``examples/quickstart.py`` and ``examples/review_rerun.py`` as they are
  and with ``repro_torch`` in place of ``repro``: the printed lines agree
  once commit oids, the dsid and the work directory are masked (commit
  oids carry times, the dsid is random); the spec ids, which carry
  neither, and every decimal number agree unmasked.
- ``chip_smoke.py``'s phase 38 on the CPU at smoke size, after phase 37.
"""
import importlib.util
import os
import re
import shutil
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import annex as jannex  # noqa: E402
from repro.core import fsio as jfsio  # noqa: E402
from repro.core import repo as jrepo  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro_torch.core import annex as pannex  # noqa: E402
from repro_torch.core import fsio as pfsio  # noqa: E402
from repro_torch.core import repo as prepo  # noqa: E402
from repro_torch.core import session as psession  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _side(annex, fsio, repo, session):
    return types.SimpleNamespace(
        Repository=repo.Repository, ConflictError=repo.ConflictError, Session=session.Session, FS=fsio.FS,
        GPFS=fsio.GPFS, NULL_FS=fsio.NULL_FS, SimClock=fsio.SimClock, parse_pointer=annex.parse_pointer)


SIDES = {"port": _side(pannex, pfsio, prepo, psession), "ref": _side(jannex, jfsio, jrepo, jsession)}
BOTH = pytest.mark.parametrize("side", ["port", "ref"])
PAIRS = pytest.mark.parametrize("maker,cloner", [("ref", "port"), ("port", "ref"), ("port", "port")])


def write(root, rel, data):
    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(p, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)


def read(root, rel) -> bytes:
    return open(os.path.join(root, rel), "rb").read()


def object_files(repo) -> dict[str, bytes]:
    """The object store's files (loose and packed) by path, without the
    port's publication tmps."""
    out = {}
    for d, _, files in os.walk(repo.objects.root):
        for f in files:
            if not f.startswith("tmp-"):
                out[os.path.relpath(os.path.join(d, f), repo.objects.root)] = read(d, f)
    return out


# ---------------------------------------------------- tests/test_core_vcs.py
@BOTH
def test_save_checkout_roundtrip(side, tmp_path):
    S = SIDES[side]
    root = str(tmp_path / "repo")
    repo = S.Repository.init(root, annex_threshold=100)
    write(root, "small.txt", "small")
    write(root, "dir/big.bin", b"\x01" * 1000)  # annexed
    c1 = repo.save(message="first")
    assert repo.tree_of(c1)["small.txt"]["t"] == "blob" and repo.tree_of(c1)["dir/big.bin"]["t"] == "annex"
    write(root, "small.txt", "changed")
    c2 = repo.save(paths=["small.txt"], message="second")
    assert c2 != c1 and repo.objects.get_commit(c2)["parents"] == [c1]
    repo.checkout(c1)
    assert read(root, "small.txt") == b"small" and read(root, "dir/big.bin") == b"\x01" * 1000
    repo.checkout(c2[:10], paths=["small.txt"])
    assert read(root, "small.txt") == b"changed"


@BOTH
def test_branches_and_octopus_merge(side, tmp_path):
    S = SIDES[side]
    root = str(tmp_path / "repo")
    repo = S.Repository.init(root)
    write(root, "base.txt", "base")
    base = repo.save(message="base")
    for j in range(3):
        repo.create_branch(f"job/{j}", at=base)
    for j in range(3):
        repo.switch(f"job/{j}")
        assert repo.current_branch() == f"job/{j}"
        write(root, f"out/{j}.txt", f"output {j}")
        repo.save(paths=[f"out/{j}.txt"], message=f"job {j}")
    repo.switch("main")
    for j in range(3):
        os.unlink(os.path.join(root, f"out/{j}.txt"))
    m = repo.merge_octopus([f"job/{j}" for j in range(3)], message="octopus")
    assert len(repo.objects.get_commit(m)["parents"]) == 4
    assert {f"out/{j}.txt" for j in range(3)} <= set(repo.tree_of(m))
    assert [read(root, f"out/{j}.txt") for j in range(3)] == [f"output {j}".encode() for j in range(3)]
    with pytest.raises(ValueError, match="no such branch"):
        repo.switch("job/9")


@BOTH
def test_octopus_merge_conflict(side, tmp_path):
    S = SIDES[side]
    root = str(tmp_path / "repo")
    repo = S.Repository.init(root)
    write(root, "base.txt", "base")
    base = repo.save(message="base")
    for j in range(2):
        repo.create_branch(f"job/{j}", at=base)
        repo.switch(f"job/{j}")
        write(root, "same.txt", f"conflicting {j}")
        repo.save(paths=["same.txt"], message=f"job {j}")
    repo.switch("main")
    with pytest.raises(S.ConflictError):
        repo.merge_octopus(["job/0", "job/1"])


@BOTH
def test_clone_knows_annexed_files_without_content(side, tmp_path):
    S = SIDES[side]
    src_root = str(tmp_path / "src")
    src = S.Repository.init(src_root, annex_threshold=10)
    write(src_root, "data.bin", b"\x03" * 50)
    write(src_root, "notes.txt", "tiny")
    src.save(message="initial")
    dst = S.Repository.clone(src, str(tmp_path / "dst"))
    assert dst.dsid == src.dsid and read(dst.root, "notes.txt") == b"tiny"
    assert S.parse_pointer(read(dst.root, "data.bin")) == src.annex_key_at("data.bin")
    assert dst.annex_get("data.bin") and read(dst.root, "data.bin") == b"\x03" * 50


# ------------------------------------------------------- across the packages
def _source(maker, root):
    S = SIDES[maker]
    repo = S.Repository.init(root, annex_threshold=64)
    write(root, "code/run.py", "print('hi')\n")
    write(root, "data/big.dat", b"\x05" * 500)
    write(root, "data/other.dat", b"\x06" * 700)
    repo.save(message="first")
    repo.create_branch("job/1")
    write(root, "code/run.py", "print('bye')\n")
    repo.save(message="second")
    return repo


@PAIRS
@pytest.mark.parametrize("repacked", [False, True])
def test_a_repository_cloned_by_the_other_package(maker, cloner, repacked, tmp_path):
    src = _source(maker, str(tmp_path / "src"))
    if repacked:
        src.objects.repack()
    C = SIDES[cloner]
    origin = C.Repository(src.root)
    dst = C.Repository.clone(origin, str(tmp_path / "dst"))
    assert dst.dsid == src.dsid and dst.branches() == src.branches() == ["job/1", "main"]
    assert dst.current_branch() == "main" and dst.head_commit() == src.head_commit()
    assert object_files(dst) == object_files(src)
    assert dst.config["annex_remotes"] == [src.annex.root] and dst.remote_by_name("remote0").root == src.annex.root
    assert read(dst.root, "code/run.py") == b"print('bye')\n"
    key = src.annex_key_at("data/big.dat")
    assert read(dst.root, "data/big.dat").startswith(b"#%REPRO-ANNEX%# " + key.encode())
    assert dst.annex_get("data/big.dat") and read(dst.root, "data/big.dat") == b"\x05" * 500
    # the other package opens, verifies and checks out the clone
    O = SIDES[maker]
    again = O.Repository(dst.root)
    assert O.Session(again).verify()["divergence"] == 0
    again.switch("job/1")
    assert read(dst.root, "code/run.py") == b"print('hi')\n"
    if repacked:
        loose = [p for p in object_files(dst) if not p.startswith("pack")]
        assert loose == [] and again.tree_of(again.head_commit())["data/other.dat"]["t"] == "annex"


@BOTH
def test_a_clone_of_a_repacked_repository_reads_from_its_packs(side, tmp_path):
    S = SIDES[side]
    src = _source(side, str(tmp_path / "src"))
    stats = src.objects.repack()
    dst = S.Repository.clone(src, str(tmp_path / "dst"))
    files = object_files(dst)
    assert files and all(p.startswith("pack" + os.sep) for p in files)
    assert sum(p.endswith(".idx") for p in files) == 1 and stats["loose_unlinked"] == stats["objects_packed"]
    fresh = S.Repository(dst.root)
    for b in ("main", "job/1"):
        flat = fresh.tree_of(fresh.branch_head(b))
        assert set(flat) == {"code/run.py", "data/big.dat", "data/other.dat"}
        assert fresh.objects.get_blob(flat["code/run.py"]["oid"]) in (b"print('hi')\n", b"print('bye')\n")


@PAIRS
def test_the_clone_carries_the_sites_and_numcopies(maker, cloner, tmp_path):
    M, C = SIDES[maker], SIDES[cloner]
    root = str(tmp_path / "src")
    src = M.Repository.init(root, annex_threshold=64, numcopies=2)
    write(root, "a.dat", b"a" * 300)
    src.save(message="seed")
    src.add_remote(str(tmp_path / "siteA"), name="siteA", net="lan")
    src.add_remote(str(tmp_path / "siteB"), name="siteB", net="wan")
    dst = C.Repository.clone(C.Repository(root), str(tmp_path / "dst"))
    assert dst.numcopies == 2 and dst.config["remotes"] == src.config["remotes"]
    assert [s.name for s in dst.remote_stores] == ["siteA", "siteB"]
    assert [s.name for s in dst._remotes] == ["remote0", "siteA", "siteB"]
    assert M.Repository(dst.root).config == dst.config


def test_a_clone_charges_the_reference_counters_but_the_tmp_publications(tmp_path):
    """Copies of one repository (with a pack, loose objects, two branches,
    an annexed file and a site) cloned by each package on GPFS: equal bytes
    read and written; the port's metadata operations are the reference's
    plus two for each file the clone copies (object files, refs, HEAD),
    each config save (the origin's annex, numcopies, each site) and each
    worktree file the checkout writes, and its modelled seconds are those
    operations' more."""
    src = _source("ref", str(tmp_path / "seed"))
    src.objects.repack()
    write(src.root, "late.txt", "loose again")
    src.save(paths=["late.txt"], message="after the repack")
    src.add_remote(str(tmp_path / "siteA"), name="siteA", net="lan")
    out = {}
    for side, S in SIDES.items():
        root = str(tmp_path / side[0])  # paths of one length: the config records the origin's
        shutil.copytree(src.root, root)
        clock = S.SimClock()
        S.Repository.clone(S.Repository(root), str(tmp_path / f"{side[0]}_clone"), fs=S.FS(S.GPFS, clock))
        out[side] = clock
    n_objects = len(object_files(src))
    n_refs, n_saves, n_worktree = 2, 3, 4  # main and job/1; remote0, numcopies, siteA; the checkout's files
    extra = 2 * (n_objects + n_refs + 1 + n_saves + n_worktree)
    port, ref = out["port"], out["ref"]
    assert (port.bytes_read, port.bytes_written) == (ref.bytes_read, ref.bytes_written)
    assert port.meta_ops - ref.meta_ops == extra
    assert port.total - ref.total == pytest.approx(extra * pfsio.GPFS.meta_op_s, rel=1e-9)


@pytest.mark.parametrize("where", ["origin", "clone"])
def test_a_switch_charges_the_reference_counters_but_the_tmp_publications(where, tmp_path):
    """``switch`` to a job branch and back, by each package on copies of one
    repository (or of its clone, whose annexed files are pointers) on GPFS:
    equal bytes read and written; the port's metadata operations are the
    reference's plus two for HEAD and two for each worktree file each
    checkout writes, and its modelled seconds are those operations' more."""
    src = _source("ref", str(tmp_path / "seed"))
    if where == "clone":
        src = jrepo.Repository.clone(src, str(tmp_path / "seed_clone"))
    out = {}
    for side, S in SIDES.items():
        root = str(tmp_path / side[0])
        shutil.copytree(src.root, root)
        clock = S.SimClock()
        repo = S.Repository(root, fs=S.FS(S.GPFS, clock))
        opened = (clock.meta_ops, clock.bytes_read, clock.bytes_written, clock.total)  # the reference sweeps on open
        repo.switch("job/1")
        assert repo.current_branch() == "job/1" and read(root, "code/run.py") == b"print('hi')\n"
        repo.switch("main")
        assert repo.current_branch() == "main" and read(root, "code/run.py") == b"print('bye')\n"
        pointer = S.parse_pointer(read(root, "data/big.dat"))
        assert (pointer is not None) == (where == "clone")
        out[side] = [now - then for now, then in zip((clock.meta_ops, clock.bytes_read, clock.bytes_written,
                                                      clock.total), opened)]
    extra = 2 * (2 + 3 + 3)  # HEAD twice; the checkouts' three files each
    port, ref = out["port"], out["ref"]
    assert port[1:3] == ref[1:3]
    assert port[0] - ref[0] == extra
    assert port[3] - ref[3] == pytest.approx(extra * pfsio.GPFS.meta_op_s, rel=1e-9)


@BOTH
def test_checkout_of_paths_writes_what_the_reference_writes(side, tmp_path):
    """``checkout(oid, paths=[...])`` writes exactly the files at and below
    the paths, in both packages alike."""
    S = SIDES[side]
    root = str(tmp_path / "repo")
    repo = S.Repository.init(root, annex_threshold=64)
    for rel in ("a/x.txt", "a/b/y.txt", "a/b/z.dat", "c/w.txt"):
        write(root, rel, rel.encode() * (30 if rel.endswith(".dat") else 1))
    c = repo.save(message="all")
    repo.annex.drop(repo.annex_key_at("a/b/z.dat"))
    for rel in ("a/x.txt", "a/b/y.txt", "a/b/z.dat", "c/w.txt"):
        os.unlink(os.path.join(root, rel))
    repo.checkout(c, paths=["a/b/"])
    assert sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) if ".repro" not in d
                  for f in fs) == ["a/b/y.txt", "a/b/z.dat"]
    assert S.parse_pointer(read(root, "a/b/z.dat")) == repo.annex_key_at("a/b/z.dat")  # no local content


# -------------------------------------------------------------- the examples
def _ported(source: str) -> str:
    return (source.replace("import repro\n", "import repro_torch as repro\n")
            .replace("from repro import", "from repro_torch import")
            .replace("from repro.core import", "from repro_torch.core import"))


# where the examples print a commit oid's 12-character abbreviation
COMMIT_AT = re.compile(r"(committed inputs: |ran \+ recorded: |octopus merge |authors committed: data |, figure )"
                       r"[0-9a-f]{12}\b")


def _masked(text: str, work: str) -> str:
    """The work directory, the dsid's 8 characters, full oids and the
    commit abbreviations at ``COMMIT_AT`` masked; everything else, decimal
    numbers included, compared as printed."""
    text = text.replace(work, "<work>")
    text = re.sub(r"spec_id [0-9a-f]{12}", "spec_id <spec>", text)
    text = re.sub(r"dsid [0-9a-f]{8}\.\.\.", "dsid <dsid>...", text)
    text = COMMIT_AT.sub(r"\1<oid>", text)
    return re.sub(r"\b[0-9a-f]{64}\b", "<oid>", text)


@pytest.mark.parametrize("example", ["quickstart.py", "review_rerun.py"])
def test_example_on_both_packages(example, tmp_path, monkeypatch, capsys):
    """The example as it is and with ``repro_torch`` in place of ``repro`` in
    its imports: every step runs on the port, and the printed lines agree
    with the reference's once the commit oids and the dsid (which carry
    times and a random uuid) and the paths are masked; the spec ids agree
    as printed."""
    source = (ROOT / "examples" / example).read_text()
    ported = _ported(source)
    assert ported != source
    printed, spec_ids = {}, {}
    for side, text in (("ref", source), ("port", ported)):
        work = tmp_path / side
        monkeypatch.setattr("tempfile.mkdtemp", lambda prefix="", _d=work: (_d.mkdir(), str(_d))[1])
        namespace = {"__name__": example[:-3]}
        exec(compile(text, f"{example[:-3]}_{side}", "exec"), namespace)
        namespace["main"]()
        out = capsys.readouterr().out
        spec_ids[side] = re.findall(r"spec_id ([0-9a-f]{12})", out)
        printed[side] = _masked(out, str(work))
    assert printed["port"] == printed["ref"]
    assert spec_ids["port"] == spec_ids["ref"] and spec_ids["port"]
    assert "OK" in printed["port"]


# --------------------------------------------------- phase 38 on the CPU
def test_gc_clone_phase_38_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phase 38 on the CPU at smoke size, after its phase
    37, in a repository holding a smoke qwen3 checkpoint: the killed repack
    and its recovery, gc, the clone, the switch to the checkpoint, the
    params fetched from ``remote0``, the serve from the clone (this
    process's tokens before the phases; the flash kernel's launches are 0
    here: the CPU runs the plain version)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.mamba import mamba_scan_fwd
    from repro_torch.kernels.rwkv6 import rwkv6_fwd
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.train.checkpoint import CheckpointManager

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    root = str(tmp_path / "repo")
    repo = prepo.Repository.init(root)
    params = init_params(T.param_defs(configs.get_smoke("qwen3_0_6b")), seed=0, dtype=torch.float32, device="cpu")
    ckpt = CheckpointManager(repo).save(3, params, {"m": {"w": torch.ones(5000)}})
    shape = dict(batch=2, prompt_len=16, gen=4)
    want = serve.run("qwen3_0_6b", full=False, device="cpu", seed=0, repo=root, commit=ckpt, **shape).tokens
    kernels = {"attn": flash_attention_fwd, "rwkv6": rwkv6_fwd, "mamba": mamba_scan_fwd}
    kw = dict(full=False, device="cpu", overrides=None, smi="cpu", shape=shape)
    smoke.remote_phase(torch, np, configs, serve, kernels, "cpu", 0, root, ckpt, want, **kw)
    launches, prefills = smoke.gc_clone_phase(torch, configs, serve, kernels, "cpu", 0, root, ckpt, want, **kw)
    assert launches == {"flash_attention_fwd": 0, "rwkv6_fwd": 0, "mamba_scan_fwd": 0} and prefills >= 1
    with repro_torch.open(root) as s:
        assert s.verify()["divergence"] == 0 and s.recover()["journals_replayed"] == 0
        # loose: only the after-gc probe's blob, root tree and commit
        assert len(smoke.loose_objects(s.repo)) == 3
