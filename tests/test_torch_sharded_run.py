"""Sharded runs of the port: 8 gloo ranks on the CPU, a ``DeviceMesh`` of
(4, 2) ``("data", "model")``, against the unsharded port and the unsharded
JAX reference (the reference's sharded lowering does not run here: ROADMAP
§A item 9).

One module-scoped fixture does the work. The parent initialises every
config's smoke weights with JAX (fp32) and writes them and the inputs to an
npz; it starts 8 rank processes, which import no JAX, and while they run it
runs the JAX reference unsharded (prefill, then 3 greedy decode steps; the
plain path, whose prefill keeps its KV cache). Each rank computes every
case; rank 0 writes the results to JSON and the sharded logits, the
elastic-restore state and what else the parent compares to an npz. Each
parametrised test asserts one case, so each case counts.

- Serving, fp32, ``use_pallas="on"`` (the kernels' wrappers, run through
  ``local_map`` on each rank's shard, take their plain versions on CPU
  tensors): every architecture at B=8 (batch-shardable over "data") and
  qwen3 at B=2 (not), prefill of 32 tokens then 3 decode steps; and qwen3
  at B=8 on a (2, 4) mesh, whose 2 KV heads do not split over 4 tp ranks.
  Logits
  within 1e-5 of the unsharded port and 1e-4 of JAX (PERF.md's parity
  tolerances), greedy tokens equal, every MoE layer's expert choices equal
  to the unsharded port's (drops follow from the choices by the capacity
  rule, and the logits hold them), the KV caches (built by prefill and
  written in place by decode) placed by ``rules.kv_cache(B >= 8)``.
- Serving from a sequence-sharded KV cache (``kv_shard="seq"``: the cache's
  slots over tp, each rank's part of the decode softmax combined by three
  all-reduces): qwen3 at B=8 on both meshes, mixtral (its window of 8 makes
  the ring cache wrap in decode), seamless (cross-attention over the
  seq-placed encoder memory) and qwen3 with a cache of 37 slots, which 4 tp
  ranks split 10, 10, 10, 7; held as above, the JAX reference run with the
  same cache length.
- Training: one fp32 step of qwen3 and mixtral, FSDP off and on, of rwkv6
  and jamba (with its experts), and of qwen3 with int8 error-feedback
  compression: the first moment (and the compression's residual) within
  rtol 1e-4 / atol 1e-6 (compressed: but for one int8 code step at 1e-3 of
  the elements) and, for qwen3 and mixtral, the params after the step
  within rtol 1e-4 / atol 1e-5 of the unsharded port's
  (``test_torch_train_steps.py``'s tolerances and rules); the AdamW moments
  placed as their params.
- Training where the query heads do not split over tp (ROADMAP §C4): one
  fp32 step of arctic's smoke config with 6 query heads and 2 KV heads on the
  (2, 4) mesh, whose attention output's backward DTensor could not view
  back to heads; the first moment and the loss held against the unsharded
  port as above and against the JAX package's step (the first moment within
  rtol 1e-4 / atol 1e-6, the loss within 1e-5).
- Elastic restore (the port of tests/test_elastic.py): the state after that
  qwen3 step, saved as step 7 from the (4, 2) mesh, restored under (2, 4):
  bitwise, every leaf on the new mesh, the manifest's step, annex keys
  equal to an unsharded save of the same tree, and the JAX package's
  ``CheckpointManager.restore`` of the commit gives the same arrays.

Without processes: ``decode_attention_part`` over 1 to 4 slices of a cache
(even and uneven splits, an empty slice, ring and not, parts wholly masked),
merged by ``combine_decode_parts``, against ``decode_attention`` of the port
and of the JAX package; and one part in bf16 and fp16, bit for bit the port's.
"""
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
WORLD, MESH_A, MESH_B, AXES = 8, (4, 2), (2, 4), ("data", "model")
PROMPT, GEN = 32, 4  # 1 token from prefill, 3 from decode steps
ARCHS = ["qwen3_0_6b", "rwkv6_1_6b", "jamba_1_5_large_398b", "internlm2_20b", "phi3_mini_3_8b",
         "granite_3_2b", "seamless_m4t_large_v2", "qwen2_vl_7b", "mixtral_8x22b", "arctic_480b"]
SERVE = [(a, 8) for a in ARCHS] + [("qwen3_0_6b", 2)]
# on the (2, 4) mesh: qwen3's 2 KV heads do not split over 4 tp ranks, so each
# rank keeps k/v whole and slices its query heads' group
SERVE_TP4 = ("qwen3_0_6b", 8)
# decode from a sequence-sharded KV cache: (arch, mesh, extra cache slots); 36 slots split
# evenly over 2 and 4 tp ranks, 37 over 4 as 10, 10, 10, 7
SERVE_SEQ = [("qwen3_0_6b", MESH_A, 0), ("qwen3_0_6b", MESH_B, 0), ("mixtral_8x22b", MESH_A, 0),
             ("seamless_m4t_large_v2", MESH_A, 0), ("qwen3_0_6b", MESH_B, 1)]
# (arch, fsdp, int8 error-feedback compression): qwen3 and mixtral with FSDP
# off and on, params held after the step; rwkv6 and jamba, whose WKV u and
# Mamba A, B and C are whole over a mesh dim their scan is split over, and
# qwen3's compressed gradients, held by the first moment (and the error
# feedback's residual): Adam's first step is lr sign(g), which flips on a tiny
# gradient (one element of a few of jamba's leaves here), as
# tests/test_torch_train_steps.py says
TRAIN = [(a, f, False) for a in ("qwen3_0_6b", "mixtral_8x22b") for f in (False, True)] + [
    ("rwkv6_1_6b", False, False), ("jamba_1_5_large_398b", False, False), ("qwen3_0_6b", False, True)]
PARAMS_HELD = {"qwen3_0_6b", "mixtral_8x22b"}
# on the (2, 4) mesh: 6 query heads (and 2 KV heads) do not split over 4 tp ranks
TRAIN_UNEVEN = ("arctic_480b", {"n_heads": 6, "n_kv_heads": 2})
UNEVEN = "arctic_480b-h6"


def _train_id(arch: str, fsdp: bool, compress: bool) -> str:
    return f"{arch}-fsdp{int(fsdp)}" + ("-int8" if compress else "")
PORT_TOL, JAX_TOL = 1e-5, 1e-4
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-6)
RANK_TIMEOUT = 600


def _case(arch: str, b: int) -> str:
    return f"{arch}-B{b}"


def _seq_suffix(mesh: tuple, extra: int) -> str:
    return "-seq" + ("-tp4" if mesh == MESH_B else "") + (f"-L{PROMPT + GEN + extra}" if extra else "")


def _inputs(cfg, b: int, seed: int = 0) -> dict:
    """tests/test_archs.py's ``make_batch`` in fp32 (numpy)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, PROMPT)).astype(np.int32)}
    if cfg.enc_dec:
        out["encoder_embeds"] = rng.normal(0, 0.02, (b, PROMPT // cfg.enc_len_ratio, cfg.d_model)).astype(np.float32)
    if cfg.vision_len_ratio:
        out["vision_embeds"] = rng.normal(0, 0.02, (b, PROMPT // cfg.vision_len_ratio, cfg.d_model)).astype(np.float32)
        out["positions3"] = np.ascontiguousarray(
            np.broadcast_to(np.arange(PROMPT, dtype=np.int32), (3, b, PROMPT)))
    return out


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat: dict) -> dict:
    root: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return root


# ------------------------------------------------------------------ the ranks
def _greedy(cfg, prefill, decode, batch) -> tuple[list, list]:
    """(logits of prefill and each decode step, tokens), full tensors."""
    from repro_torch.train.steps import greedy_token

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    caches, logits = prefill(batch)
    tok = greedy_token(cfg, logits)
    lg, toks = [full(logits)], [full(tok)]
    for i in range(GEN - 1):
        logits, caches = decode(caches, tok, PROMPT + i)
        tok = greedy_token(cfg, logits)
        lg.append(full(logits))
        toks.append(full(tok))
    return lg, toks, caches


def _routes(moe):
    """Patch ``moe.router_topk`` to record each call's expert choices (full
    tensors); returns (the list, a function that undoes the patch)."""
    orig, got = moe.router_topk, []

    def record(x, w, cfg):
        gates, idx, aux = orig(x, w, cfg)
        got.append((idx.full_tensor() if hasattr(idx, "full_tensor") else idx).clone())
        return gates, idx, aux

    moe.router_topk = record
    return got, lambda: setattr(moe, "router_topk", orig)


def _serve_case(mesh, data, arch, b, res, arrays, suffix="", kv_shard=None, extra=0):
    from repro_torch import configs
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed.sharding import P, placements, rules_for
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = configs.get_smoke(arch).replace(use_pallas="on")
    cfg = cfg.replace(decode_kv_shard=kv_shard) if kv_shard else cfg
    rules = rules_for(cfg, mesh)
    key = _case(arch, b)
    tree = _nest({p[len(arch) + 1:]: data[p] for p in data.files if p.startswith(arch + "/")})
    batch = {k: torch.from_numpy(data[f"in/{key}/{k}"]) for k in _inputs(cfg, b)}
    key += suffix
    cache_len = PROMPT + GEN + extra
    runs = {}
    for name, r in (("port", None), ("sharded", rules)):
        params = params_from_numpy(tree, "cpu", rules=r, cfg=cfg)
        pre, dec = make_prefill_step(cfg, cache_len, rules=r), make_decode_step(cfg, rules=r)
        routes, undo = _routes(moe)
        try:
            lg, toks, caches = _greedy(cfg, lambda bt: pre(params, bt),
                                       lambda c, t, pos: dec(params, c, t, pos), batch)
        finally:
            undo()
        runs[name] = (lg, toks, routes, caches)
    (lg0, tok0, rt0, _), (lg1, tok1, rt1, caches) = runs["port"], runs["sharded"]
    want_kv = placements(P(None, *rules.kv_cache(b >= 8)), mesh)
    kv_ok = all(tuple(c[n].placements) == want_kv for c in caches.values() for n in ("k", "v", "xk", "xv")
                if n in c)
    res[key] = {
        "port_err": max(float((a - w).abs().max()) for a, w in zip(lg1, lg0)),
        "tokens_equal_port": all(torch.equal(a, w) for a, w in zip(tok1, tok0)),
        "n_routes": len(rt0),
        "routes_equal": len(rt0) == len(rt1) and all(torch.equal(a, w) for a, w in zip(rt1, rt0)),
        "kv_layers": sum("k" in c for c in caches.values()),
        "kv_placed": kv_ok,
        "kv_spec": [str(x) for x in rules.kv_cache(b >= 8)],
        "k_local_slots": [c["k"]._local_tensor.shape[2] for c in caches.values() if "k" in c][:1],
    }
    for i, (a, t) in enumerate(zip(lg1, tok1)):
        arrays[f"{key}/logits{i}"] = a.numpy()
        arrays[f"{key}/token{i}"] = t.numpy()


def _code_close(got, want, code_step) -> bool:
    """Within MOMENT_TOL, but for at most 1e-3 of the elements, each within
    ``code_step``: with int8 compression a gradient within ~1e-7 of a rounding
    boundary may take the next code in one run, which moves that element's
    residual by one code step and its m by a tenth of it
    (tests/test_torch_train_steps.py's rule for the packages)."""
    off = ~torch.isclose(got, want, **MOMENT_TOL)
    return bool(off.float().mean() <= 1e-3 and ((got - want).abs()[off] <= code_step + 1e-6).all()) if code_step \
        else not bool(off.any())


def _train_case(mesh, data, arch, fsdp, compress, res, state_out, change=None, key=None, arrays=None):
    """One train step sharded and unsharded. ``change`` replaces fields of
    the smoke config, whose weights and tokens are then under ``key`` in
    ``data``; with ``arrays``, the sharded step's loss and first moments go
    there for the parent's JAX comparison."""
    from repro_torch import configs
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import leaves
    from repro_torch.train.steps import make_train_step

    cfg = configs.get_smoke(arch).replace(use_pallas="on", **(change or {}))
    rules = rules_for(cfg, mesh, fsdp=fsdp)
    key = key or arch
    tree = _nest({p[len(key) + 1:]: data[p] for p in data.files if p.startswith(key + "/")})
    batch = {"tokens": torch.from_numpy(data[f"train/{key}/tokens"])}
    opt = AdamW(lr=1e-3)
    out = {}
    for name, r in (("port", None), ("sharded", rules)):
        params = params_from_numpy(tree, "cpu", rules=r, cfg=cfg)
        state = opt.init(params)
        params, state, metrics = make_train_step(cfg, opt, compress, rules=r)(params, state, batch)
        out[name] = (params, state, metrics)
    (p0, s0, m0), (p1, s1, m1) = out["port"], out["sharded"]
    worst, ok = 0.0, True
    for a, w in zip(leaves(p1), leaves(p0)):
        a, w = a.full_tensor().detach(), w.detach()
        ok &= bool(torch.allclose(a, w, **STEP_TOL))
        worst = max(worst, float((a - w).abs().max()))
    m_ok = all(_code_close(a.full_tensor(), w, step(w) if compress else 0.0)
               for name, step in (("m", lambda w: 4 * w.abs().max() / 127), ("ef_residual", lambda w: 2 * w.abs().max()))
               for a, w in zip(leaves(s1.get(name, {})), leaves(s0.get(name, {}))))
    f0, f1 = _flat(p0), _flat(p1)
    bad = [(k, int((~torch.isclose(f1[k].full_tensor().detach(), f0[k].detach(), **STEP_TOL)).sum()))
           for k in f0 if not torch.allclose(f1[k].full_tensor().detach(), f0[k].detach(), **STEP_TOL)]
    moments = all(m.placements == p.placements and v.placements == p.placements
                  for m, v, p in zip(leaves(s1["m"]), leaves(s1["v"]), leaves(p1)))
    loss = (float(m1["loss"].full_tensor() if hasattr(m1["loss"], "full_tensor") else m1["loss"]),
            float(m0["loss"]))
    if arrays is not None:
        arrays[f"train/{key}/loss"] = np.float32(loss[0])
        arrays.update({f"train/{key}/m/{p}": v.full_tensor().detach().numpy() for p, v in _flat(s1["m"]).items()})
    res[key if change else _train_id(arch, fsdp, compress)] = {"params_close": ok, "params_max_abs_err": worst, "m_close": m_ok, "bad": bad[:5],
                                      "moments_placed": moments, "loss": loss}
    if arch == "qwen3_0_6b" and not fsdp and not compress:
        state_out.update(params=p1, opt_state=s1, cfg=cfg)


def _loss_comms(mesh, res):
    """The collectives of ``masked_loss`` on vocab-sharded fp32 logits (the
    sharded lm head's placement), and its value against the unsharded one."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed.sharding import distribute_local, make_rules, sharded_region
    from repro_torch.train.steps import masked_loss

    gen = torch.Generator().manual_seed(3)
    logits, tokens = torch.randn(8, PROMPT, 512, generator=gen), torch.randint(0, 500, (8, PROMPT), generator=gen)
    placed = distribute_local(logits, mesh, (Shard(0), Shard(2)))
    with sharded_region(make_rules(mesh)), CommDebugMode() as comms:
        loss = masked_loss(placed, tokens, 500)
    res["loss_comms"] = {"counts": {str(k): v for k, v in comms.get_comm_counts().items()},
                         "loss": [float(loss.full_tensor()), float(masked_loss(logits, tokens, 500))]}


def _bits(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _elastic(mesh_b, state, workdir, res, arrays):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch.core.repo import Repository
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.models import transformer as T
    from repro_torch.models.params import param_shardings
    from repro_torch.train.checkpoint import CheckpointManager, _flatten

    cfg, params, opt_state = state["cfg"], state["params"], state["opt_state"]
    root = workdir / "elastic"
    if dist.get_rank() == 0:
        Repository.init(str(root))
    dist.barrier()
    ckpt = CheckpointManager(Repository(str(root)))
    oid = ckpt.save(7, params, opt_state, data_step=7)
    saved = {p: (v.full_tensor() if hasattr(v, "full_tensor") else v).detach()
             for p, v in _flatten({"params": params, "opt_state": opt_state}).items()}

    rules_b = rules_for(cfg, mesh_b)
    placed = param_shardings(T.param_defs(cfg, rules_b), rules_b)
    shardings = {"params": placed, "opt_state": {"m": placed, "v": placed,
                                                 "step": (mesh_b, (Replicate(), Replicate()))}}
    got, manifest = ckpt.restore(shardings=shardings, device="cpu")
    flat = _flatten(got)
    bitwise = sorted(flat) == sorted(saved) and all(
        flat[p].dtype == saved[p].dtype and torch.equal(_bits(flat[p].full_tensor()), _bits(saved[p])) for p in saved)
    on_b = all(tuple(t.device_mesh.shape) == MESH_B and tuple(t.device_mesh.mesh_dim_names) == AXES
               for t in flat.values())
    placements_b = all(flat[f"params/{p}"].placements == pl[1] for p, pl in _flatten(placed).items())
    res["elastic"] = {"oid": oid, "bitwise": bitwise, "on_mesh_b": on_b, "placements_b": placements_b,
                      "step": manifest["step"], "oid_same_on_ranks": None}
    oids = [None] * dist.get_world_size()
    dist.all_gather_object(oids, oid)
    res["elastic"]["oid_same_on_ranks"] = len(set(oids)) == 1
    if dist.get_rank() == 0:
        plain = CheckpointManager(Repository.init(str(workdir / "unsharded")))
        plain.save(7, _nest({p[len("params/"):]: v for p, v in saved.items() if p.startswith("params/")}),
                   _nest({p[len("opt_state/"):]: v for p, v in saved.items() if p.startswith("opt_state/")}),
                   data_step=7)
        keys = {p: m["key"] for p, m in manifest["leaves"].items()}
        _, plain_manifest = plain.restore(device="cpu")
        res["elastic"]["keys_equal_unsharded"] = keys == {p: m["key"] for p, m in plain_manifest["leaves"].items()}
        res["elastic"]["root"] = str(root)
        for p, v in saved.items():
            arrays[f"elastic/{p}"] = v.numpy()


def _rank_main(rank: int, workdir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    work = Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank, world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", MESH_A, mesh_dim_names=AXES)
        mesh_b = init_device_mesh("cpu", MESH_B, mesh_dim_names=AXES)
        data = np.load(work / "inputs.npz")
        res, arrays, state, times = {"serve": {}, "train": {}}, {}, {}, {}
        for arch, b in SERVE:
            t = time.perf_counter()
            _serve_case(mesh, data, arch, b, res["serve"], arrays)
            times[_case(arch, b)] = time.perf_counter() - t
        t = time.perf_counter()
        _serve_case(mesh_b, data, *SERVE_TP4, res["serve"], arrays, suffix="-tp4")
        times[_case(*SERVE_TP4) + "-tp4"] = time.perf_counter() - t
        for arch, shape, extra in SERVE_SEQ:
            t = time.perf_counter()
            suffix = _seq_suffix(shape, extra)
            _serve_case(mesh if shape == MESH_A else mesh_b, data, arch, 8, res["serve"], arrays, suffix=suffix,
                        kv_shard="seq", extra=extra)
            times[_case(arch, 8) + suffix] = time.perf_counter() - t
        for case in TRAIN:
            t = time.perf_counter()
            _train_case(mesh, data, *case, res["train"], state)
            times[f"train {_train_id(*case)}"] = time.perf_counter() - t
        t = time.perf_counter()
        _train_case(mesh_b, data, TRAIN_UNEVEN[0], False, False, res["train"], state, change=TRAIN_UNEVEN[1],
                    key=UNEVEN, arrays=arrays)
        times[f"train {UNEVEN}"] = time.perf_counter() - t
        _loss_comms(mesh, res)
        t = time.perf_counter()
        _elastic(mesh_b, state, work, res, arrays)
        times["elastic"] = time.perf_counter() - t
        res["seconds"] = times
        if rank == 0:
            np.savez(work / "sharded.npz", **arrays)
            (work / "results.json").write_text(json.dumps(res, indent=1))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ the parent
def _jax_reference(jconfigs, data) -> dict:
    """Unsharded JAX: logits and greedy tokens of prefill and each decode
    step; for each cache length of ``SERVE_SEQ`` past the others', again
    under ``{case}-L{length}``."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT

    out = {}
    runs = [(a, b, 0) for a, b in SERVE] + sorted({(a, 8, x) for a, _, x in SERVE_SEQ if x})
    for arch, b, extra in runs:
        jcfg = jconfigs.get_smoke(arch).replace(use_pallas="off")
        key = _case(arch, b)
        params = _nest({p[len(arch) + 1:]: jnp.asarray(data[p]) for p in data.files if p.startswith(arch + "/")})
        batch = {k: jnp.asarray(data[f"in/{key}/{k}"]) for k in _inputs(jcfg, b)}
        key += f"-L{PROMPT + GEN + extra}" if extra else ""
        caches, logits = jax.jit(lambda p, bt: JT.prefill(jcfg, None, p, bt, cache_len=PROMPT + GEN + extra))(
            params, batch)
        step = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, None, p, c, t, pos))
        for i in range(GEN):
            tok = jnp.argmax(logits[:, : jcfg.vocab_size], axis=-1)[:, None].astype(jnp.int32)
            out[f"{key}/logits{i}"], out[f"{key}/token{i}"] = np.asarray(logits), np.asarray(tok)
            if i < GEN - 1:
                logits, caches = step(params, caches, tok, jnp.int32(PROMPT + i))
    return out


def _jax_train_uneven(data) -> dict:
    """The JAX package's fp32 train step of ``TRAIN_UNEVEN``: its loss and
    first moments."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.optim.adamw import AdamW as JAdamW
    from repro.train.steps import make_train_step

    jcfg = jconfigs.get_smoke(TRAIN_UNEVEN[0]).replace(**TRAIN_UNEVEN[1])
    params = _nest({p[len(UNEVEN) + 1:]: jnp.asarray(data[p]) for p in data.files if p.startswith(UNEVEN + "/")})
    opt = JAdamW(lr=1e-3)
    batch = {"tokens": jnp.asarray(data[f"train/{UNEVEN}/tokens"])}
    _, state, metrics = jax.jit(make_train_step(jcfg, None, opt))(params, opt.init(params), batch)
    out = {f"train/{UNEVEN}/loss": np.asarray(metrics["loss"])}
    out.update({f"train/{UNEVEN}/m/{p}": np.asarray(v) for p, v in _flat(state["m"]).items()})
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import transformer as JT
    from repro.models.params import init_params as jax_init_params

    work = tmp_path_factory.mktemp("sharded")
    arrays = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_smoke(arch)
        params = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
        arrays.update({f"{arch}/{p}": np.asarray(v) for p, v in _flat(jax.tree.map(np.asarray, params)).items()})
    for arch, b in SERVE:
        for k, v in _inputs(jconfigs.get_smoke(arch), b).items():
            arrays[f"in/{_case(arch, b)}/{k}"] = v
    for arch, _, _ in TRAIN:
        arrays[f"train/{arch}/tokens"] = _inputs(jconfigs.get_smoke(arch), 8, seed=1)["tokens"]
    jcfg = jconfigs.get_smoke(TRAIN_UNEVEN[0]).replace(**TRAIN_UNEVEN[1])
    params = jax_init_params(JT.param_defs(jcfg), seed=0, dtype=jnp.float32)
    arrays.update({f"{UNEVEN}/{p}": np.asarray(v) for p, v in _flat(jax.tree.map(np.asarray, params)).items()})
    arrays[f"train/{UNEVEN}/tokens"] = _inputs(jcfg, 8, seed=1)["tokens"]
    np.savez(work / "inputs.npz", **arrays)

    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
           "OMP_NUM_THREADS": "1"}
    code = "import sys; from test_torch_sharded_run import _rank_main; _rank_main(int(sys.argv[1]), sys.argv[2])"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(work)], env=env, cwd=work,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    try:
        want = _jax_reference(jconfigs, np.load(work / "inputs.npz"))
        want.update(_jax_train_uneven(np.load(work / "inputs.npz")))
        outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    failed = [(r, p.returncode, err[-3000:]) for r, (p, (_, err)) in enumerate(zip(procs, outs)) if p.returncode]
    assert not failed, f"ranks failed: {failed[:2]}"
    res = json.loads((work / "results.json").read_text())
    res["wall_s"] = time.perf_counter() - t0
    return res, dict(np.load(work / "sharded.npz")), want


SERVE_IDS = [(a, b, "") for a, b in SERVE] + [(*SERVE_TP4, "-tp4")]


@pytest.mark.parametrize("arch,b,suffix", SERVE_IDS, ids=[_case(a, b) + s for a, b, s in SERVE_IDS])
def test_sharded_serving_matches_unsharded_port_and_jax(run, arch, b, suffix):
    res, got, want = run
    r = res["serve"][_case(arch, b) + suffix]
    assert r["port_err"] <= PORT_TOL, r
    assert r["tokens_equal_port"], r
    for i in range(GEN):
        key = f"{_case(arch, b)}/logits{i}"
        np.testing.assert_allclose(got[f"{_case(arch, b)}{suffix}/logits{i}"], want[key], rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=key + suffix)
        np.testing.assert_array_equal(got[f"{_case(arch, b)}{suffix}/token{i}"], want[f"{_case(arch, b)}/token{i}"])
    assert r["routes_equal"], r
    assert (r["n_routes"] > 0) == (arch in ("jamba_1_5_large_398b", "mixtral_8x22b", "arctic_480b")), r
    assert r["kv_placed"] and (r["kv_layers"] > 0) == (arch != "rwkv6_1_6b"), r


SEQ_IDS = [_case(a, 8) + _seq_suffix(m, x) for a, m, x in SERVE_SEQ]


@pytest.mark.parametrize("arch,mesh,extra", SERVE_SEQ, ids=SEQ_IDS)
def test_decode_from_a_sequence_sharded_cache_matches_unsharded_port_and_jax(run, arch, mesh, extra):
    """``kv_shard="seq"``: the KV caches (and seamless's projected memory)
    placed with their slots over tp, each rank scoring its slots; greedy
    tokens equal to the unsharded port's and the JAX package's, logits
    within PORT_TOL and JAX_TOL, at the JAX run's own cache length."""
    res, got, want = run
    key = _case(arch, 8) + _seq_suffix(mesh, extra)
    r = res["serve"][key]
    assert r["kv_spec"] == ["data", "model", "None", "None"] and r["kv_placed"] and r["kv_layers"] > 0, r
    assert r["k_local_slots"] == [-(-_cache_slots(arch, extra) // mesh[1])], r  # rank 0's, as torch.chunk splits
    assert r["port_err"] <= PORT_TOL, r
    assert r["tokens_equal_port"] and r["routes_equal"], r
    ref = _case(arch, 8) + (f"-L{PROMPT + GEN + extra}" if extra else "")
    for i in range(GEN):
        np.testing.assert_allclose(got[f"{key}/logits{i}"], want[f"{ref}/logits{i}"], rtol=JAX_TOL, atol=JAX_TOL,
                                   err_msg=f"{key} logits{i}")
        np.testing.assert_array_equal(got[f"{key}/token{i}"], want[f"{ref}/token{i}"])


def _cache_slots(arch: str, extra: int) -> int:
    """The KV cache's slots: the cache length, or the smoke config's sliding
    window where that is shorter (the ring)."""
    from repro_torch import configs

    return min(PROMPT + GEN + extra, configs.get_smoke(arch).sliding_window or PROMPT + GEN + extra)


def _combine_cases():
    """(n_parts, even, ring, late): a cache of 6 n slots (even) or 6 n + 1
    (uneven), split as torch.chunk splits it, padded with empty parts to n
    (DTensor's rule: 3 x 3 slots over 4 ranks leaves the last none); the new
    token early (pos = S // 3: later parts wholly masked) or late (the last
    slot; with a ring, past a wrap)."""
    return list(itertools.product((1, 2, 3, 4), (True, False), (False, True), (False, True)))


@pytest.mark.parametrize("n_parts,even,ring,late", _combine_cases(),
                         ids=[f"{n}parts-{'even' if e else 'uneven'}-{'ring' if r else 'flat'}-{'late' if t else 'early'}"
                              for n, e, r, t in _combine_cases()])
def test_decode_parts_combine_to_decode_attention(n_parts, even, ring, late):
    import jax.numpy as jnp

    from repro.models.attention import decode_attention as jax_decode_attention
    from repro_torch.models.attention import combine_decode_parts, decode_attention, decode_attention_part

    s = 6 * n_parts + (0 if even else 1)
    if n_parts == 4 and not even:
        s = 9  # 3, 3, 3 and an empty part
    pos = (s - 1 + (s + 3 if ring else 0)) if late else s // 3
    rng = np.random.default_rng(n_parts * 16 + even * 8 + ring * 4 + late)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for shape in ((2, 1, 4, 16), (2, s, 2, 16), (2, s, 2, 16)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    slots = list(torch.arange(s).chunk(n_parts))
    slots += [torch.arange(0)] * (n_parts - len(slots))
    parts = [decode_attention_part(tq, tk[:, idx], tv[:, idx], pos, int(idx[0]) if len(idx) else s, s, ring=ring)
             for idx in slots]
    got = combine_decode_parts(parts, tv.dtype)
    assert got.dtype == torch.float32 and got.shape == (2, 1, 4, 16)
    np.testing.assert_allclose(got.numpy(), decode_attention(tq, tk, tv, pos, ring=ring).numpy(),
                               rtol=1e-6, atol=1e-6)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos), ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("ring", [False, True])
def test_one_decode_part_is_decode_attention_bit_for_bit(dtype, ring):
    """A whole cache as one part (one tp rank) in a 16-bit type gives
    ``decode_attention``'s output bit for bit: a bf16 greedy decode changes
    tokens under a one-ulp change of a few attention outputs. (In fp32 the
    combine's l o / l keeps an ulp; the combine cases above hold it.)"""
    from repro_torch.models.attention import combine_decode_parts, decode_attention, decode_attention_part

    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(getattr(torch, dtype))
               for shape in ((8, 1, 16, 128), (8, 136, 8, 128), (8, 136, 8, 128)))
    for pos in (20, 128, 300):
        got = combine_decode_parts([decode_attention_part(q, k, v, pos, 0, 136, ring=ring)], v.dtype)
        assert torch.equal(got, decode_attention(q, k, v, pos, ring=ring)), pos


@pytest.mark.parametrize("arch,fsdp,compress", TRAIN, ids=[_train_id(*c) for c in TRAIN])
def test_sharded_train_step_matches_unsharded_port(run, arch, fsdp, compress):
    r = run[0]["train"][_train_id(arch, fsdp, compress)]
    assert r["m_close"], r
    assert r["params_close"] or arch not in PARAMS_HELD or compress, r
    assert r["moments_placed"], r
    assert abs(r["loss"][0] - r["loss"][1]) <= STEP_TOL["atol"] + STEP_TOL["rtol"] * abs(r["loss"][1]), r


def test_sharded_train_step_where_heads_do_not_split_over_tp(run):
    """ROADMAP §C4: 6 query heads over 4 tp ranks. The gradient of the
    flattened attention output comes back from the tp-sharded ``wo`` sharded
    over the fused H * Dh dim, which DTensor cannot view back to heads unless
    the output is first placed whole over tp (``transformer._merge_heads``).
    The step against the unsharded port and the JAX package's."""
    res, got, want = run
    r = res["train"][UNEVEN]
    assert r["m_close"] and r["moments_placed"], r
    assert abs(r["loss"][0] - r["loss"][1]) <= STEP_TOL["atol"] + STEP_TOL["rtol"] * abs(r["loss"][1]), r
    np.testing.assert_allclose(got[f"train/{UNEVEN}/loss"], want[f"train/{UNEVEN}/loss"], rtol=0, atol=1e-5)
    moments = sorted(k for k in want if k.startswith(f"train/{UNEVEN}/m/"))
    assert moments and moments == sorted(k for k in got if k.startswith(f"train/{UNEVEN}/m/"))
    for k in moments:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **MOMENT_TOL)


def test_sharded_loss_gathers_no_logits(run):
    """``masked_loss`` on logits sharded over the vocab reduces partial sums
    (the reference's one-hot contraction avoids the gather too): no
    all-gather, and the unsharded value to fp32 rounding."""
    r = run[0]["loss_comms"]
    assert r["counts"] and not any("all_gather" in k for k in r["counts"]), r
    assert abs(r["loss"][0] - r["loss"][1]) <= 1e-6 * abs(r["loss"][1]), r


def test_elastic_restore_across_meshes(run):
    r = run[0]["elastic"]
    assert r["bitwise"] and r["on_mesh_b"] and r["placements_b"], r
    assert r["step"] == 7 and r["oid_same_on_ranks"], r
    assert r["keys_equal_unsharded"], r


def test_jax_package_restores_the_sharded_save(run):
    from repro.core.repo import Repository as JRepository
    from repro.train.checkpoint import CheckpointManager as JCheckpointManager

    res, got, _ = run
    state, manifest = JCheckpointManager(JRepository(res["elastic"]["root"])).restore(res["elastic"]["oid"])
    assert manifest["step"] == 7
    flat = _flat(state)
    want = {k[len("elastic/"):]: v for k, v in got.items() if k.startswith("elastic/")}
    assert sorted(flat) == sorted(want)
    for p, w in want.items():
        np.testing.assert_array_equal(np.asarray(flat[p]), w, err_msg=p)
