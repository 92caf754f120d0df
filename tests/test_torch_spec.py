"""The port's spec layer and §5.4/§5.5 conflict checks against ``repro.core``
(``repro_torch.core.spec``, ``conflicts`` and ``jobdb``'s checks). Neither
side imports jax.

- ``RunSpec``: ``to_json``, ``canonical_bytes`` and ``spec_id`` equal for
  hypothesis-drawn specs, whatever order their env is given in, and for each
  permutation of their inputs and outputs (which may change the id, equally
  in both); ``from_json``/``from_canonical`` across the packages;
  ``record_cmd``, ``title``, ``replace`` and the validation refusals, with
  the same exception classes.
- ``normalize``, ``proper_prefixes``, ``has_wildcard`` and ``check_intra_job``
  equal on drawn paths; the §5.4 wildcard refusal in specs.
- §5.5: an output equal to, under, or above an open job's output, and one
  beside it, gets the same decision and the same exception class from
  ``ProtectedOutputs`` and from the job database in both packages.
"""
import json
import os
import string

import pytest

pytest.importorskip("torch")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import conflicts as JC  # noqa: E402
from repro.core import spec as JS  # noqa: E402
from repro.core.jobdb import JobDB as JJobDB  # noqa: E402
from repro_torch.core import conflicts as C  # noqa: E402
from repro_torch.core import spec as S  # noqa: E402
from repro_torch.core.jobdb import JobDB  # noqa: E402

# derandomized: every run draws the same examples
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])

# a part that starts with ".." (or is ".") is refused as escaping the repository, by both packages
_part = st.text(alphabet=string.ascii_lowercase + string.digits + "_.-", min_size=1, max_size=6).filter(
    lambda p: p != "." and not p.startswith(".."))
paths = st.lists(_part, min_size=1, max_size=4).map("/".join)
# raw paths: slashes, dots, backslashes, wildcards, leading '/'
raw_paths = st.text(alphabet="ab/.\\*?[]{}-_", min_size=1, max_size=12)


def _disjoint(outs: list[str]) -> list[str]:
    """Drop outputs equal to or nested under an earlier one (a spec refuses them)."""
    kept: list[str] = []
    for o in outs:
        if not any(o == k or o.startswith(k + "/") or k.startswith(o + "/") for k in kept):
            kept.append(o)
    return kept


@st.composite
def spec_fields(draw):
    kind = draw(st.sampled_from(["cmd", "script"]))
    outs = _disjoint(draw(st.lists(paths, min_size=1 if kind == "script" else 0, max_size=4)))
    f = {
        "inputs": tuple(draw(st.lists(paths, max_size=4))),
        "outputs": tuple(outs),
        "pwd": draw(st.sampled_from([".", "sub", "a/b"])),
        "message": draw(st.text(max_size=10)),
        "env": tuple(draw(st.dictionaries(st.sampled_from(["A", "B", "PYTHONPATH", "X_1"]),
                                          st.text(max_size=8), max_size=3)).items()),
        "time_limit_s": draw(st.one_of(st.none(), st.integers(1, 10_000), st.floats(0.5, 1e4))),
    }
    if kind == "cmd":
        f["cmd"] = draw(st.text(min_size=1, max_size=20))
    else:
        f["script"] = draw(st.sampled_from(["slurm.sh", "jobs/run.sh"]))
        f["script_args"] = draw(st.text(max_size=8))
        f["alt_dir"] = draw(st.one_of(st.none(), st.just("/scratch/alt")))
        f["array_n"] = draw(st.integers(1, 4))
    return f


def _outcome(fn, *args):
    """(result, None) or (None, exception class name)."""
    try:
        return fn(*args), None
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return None, type(e).__name__


@SETTINGS
@given(spec_fields(), st.randoms(use_true_random=False))
def test_spec_id_and_canonical_bytes_match_reference(fields, rnd):
    for order in range(3):
        f = dict(fields)
        if order:  # a permutation of the inputs and of the outputs, and of the env
            f["inputs"] = tuple(rnd.sample(list(f["inputs"]), len(f["inputs"])))
            f["outputs"] = tuple(rnd.sample(list(f["outputs"]), len(f["outputs"])))
            f["env"] = tuple(rnd.sample(list(f["env"]), len(f["env"])))
        mine, ref = S.RunSpec(**f), JS.RunSpec(**f)
        assert mine.to_json() == ref.to_json()
        assert mine.canonical_bytes() == ref.canonical_bytes()
        assert mine.spec_id == ref.spec_id
        assert (mine.kind, mine.record_cmd, mine.title()) == (ref.kind, ref.record_cmd, ref.title())
        # each package reads the other's JSON and canonical bytes back to the same id
        assert JS.RunSpec.from_json(mine.to_json()).spec_id == mine.spec_id
        assert S.RunSpec.from_canonical(ref.canonical_bytes()).spec_id == ref.spec_id
        assert S.RunSpec.from_canonical(ref.canonical_bytes().decode()) == mine
        assert mine.replace(message="other").spec_id == ref.replace(message="other").spec_id
        entries = [(p, {"t": "blob", "oid": f"{i:064x}"}) for i, p in enumerate(f["inputs"])]
        assert mine.execution_key(entries, "fp") == ref.execution_key(entries, "fp")


def test_spec_id_ignores_env_order_and_number_spelling():
    a = S.RunSpec(script="s.sh", outputs=["o"], env={"B": "2", "A": "1"}, time_limit_s=60)
    b = S.RunSpec(script="s.sh", outputs=("o",), env=[("A", "1"), ("B", "2")], time_limit_s=60.0)
    assert a.spec_id == b.spec_id == JS.RunSpec(script="s.sh", outputs=["o"], env={"A": "1", "B": "2"},
                                                 time_limit_s=60).spec_id


@pytest.mark.parametrize("fields", [
    {},  # neither cmd nor script
    {"cmd": "true", "script": "job.sh", "outputs": ["o"]},
    {"script": "job.sh", "outputs": []},  # §5.2: outputs are mandatory
    {"cmd": "true", "array_n": 2},
    {"script": "job.sh", "outputs": ["o/*.npy"]},  # §5.4
    {"script": "job.sh", "outputs": ["a", "a/b"]},  # nested in one job
    {"script": "job.sh", "outputs": ["a", "./a"]},  # listed twice
    {"script": "job.sh", "outputs": ["../out"]},
    {"script": "job.sh", "outputs": "o"},  # a bare string
    {"script": "job.sh", "outputs": ["o"], "array_n": 0},
    {"script": "job.sh", "outputs": ["o"], "time_limit_s": 0},
    {"script": "job.sh", "outputs": ["o"], "pwd": "/abs"},
    {"script": "job.sh", "outputs": ["o"], "pwd": "../up"},
    {"script": "job.sh", "outputs": ["o"], "env": [("A", "1"), ("A", "2")]},
], ids=lambda f: json.dumps(f, sort_keys=True))
def test_spec_refusals_match_reference(fields):
    _, mine = _outcome(lambda: S.RunSpec(**fields))
    _, ref = _outcome(lambda: JS.RunSpec(**fields))
    assert mine is not None and mine == ref


def test_spec_from_json_refuses_a_newer_version():
    d = S.RunSpec(cmd="true").to_json() | {"spec_version": S.SPEC_VERSION + 1}
    with pytest.raises(S.SpecError, match="newer"):
        S.RunSpec.from_json(d)


@SETTINGS
@given(st.lists(raw_paths, min_size=1, max_size=4))
def test_path_rules_match_reference(names):
    for n in names:
        assert C.has_wildcard(n) == JC.has_wildcard(n)
        assert _outcome(C.normalize, n) == _outcome(JC.normalize, n)
        norm, err = _outcome(JC.normalize, n)
        if err is None:
            assert C.proper_prefixes(norm) == JC.proper_prefixes(norm)
    normed = [JC.normalize(n) for n in names if _outcome(JC.normalize, n)[1] is None]
    assert _outcome(C.check_intra_job, normed) == _outcome(JC.check_intra_job, normed)


# the §5.5 cases: an open job holds "data/run1" (and so protects prefix "data")
HELD = "data/run1"
CASES = {
    "equal": "data/run1",
    "under": "data/run1/part.npy",
    "above": "data",
    "beside": "data/run2",
    "elsewhere": "logs/run1",
    "normalised_equal": "./data//run1/",
    "wildcard": "data/run*",
}


def _decide(package: str, store: str, tmp_path, name: str):
    """The exception class name (or None) when ``name`` is checked against a
    protected ``HELD`` in ``package``'s ``store`` (in-memory sets or job DB)."""
    conflicts, jobdb, spec = {"port": (C, JobDB, S), "ref": (JC, JJobDB, JS)}[package]
    if store == "sets":
        po = conflicts.ProtectedOutputs()
        po.check_and_add_all([HELD], job_id=1)
        return _outcome(po.check, name)[1]
    d = tmp_path / f"{package}-{name.replace('/', '_').replace('*', 'x')}" / ".repro"
    os.makedirs(d)
    db = jobdb(str(d))
    db.add_jobs([spec.RunSpec(script="a.sh", outputs=[HELD])])
    checked = _outcome(db.check_outputs, [name])[1]
    # a batch that claims it fails as a whole and protects nothing more
    n_before = db.n_protected()
    added = _outcome(lambda: db.add_jobs([spec.RunSpec(script="ok.sh", outputs=["free/x"]),
                                          spec.RunSpec(script="b.sh", outputs=[name])]))[1]
    return checked, added, db.n_protected() - n_before


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("store", ["sets", "jobdb"])
def test_conflict_decisions_match_reference(case, store, tmp_path):
    name = CASES[case]
    mine, ref = _decide("port", store, tmp_path, name), _decide("ref", store, tmp_path, name)
    assert mine == ref
    refused = {"equal", "under", "above", "normalised_equal", "wildcard"}
    decision = mine if store == "sets" else mine[0]
    assert (decision is not None) == (case in refused)
    if store == "jobdb" and case in refused:
        assert mine[1] == mine[0] and mine[2] == 0  # the batch rolled back whole
