"""Training steps back to back, through the port's ``make_train_step`` with
its ``AdamW`` (the path ``launch/train.py`` trains through: bf16 weights,
fp32 moments, remat as the config sets it), on ``batch`` rows of
``seq_len`` tokens drawn anew from the seed for every step.

Set-up builds the one train step object with the model and optimizer
state, and drives it through the first ``checked_steps`` steps, by the
window's own call and feed: they warm up every shape, and their outputs are
what ``correct`` judges (each step's loss; after the first step each leaf's
clipped gradient, read from AdamW's first moment; after the last each
leaf's change of weights, against the weights drawn again from the seed).
The window then runs the same object on until ``--seconds`` have passed,
ending at the first step that completes after that: every step in it
counts, over all of its time. With ``--trace 1`` the profiler covers the
window's first ``trace_steps`` steps.

Once the window has closed and the peak memory is read, the port's state is
dropped and the reference runs the checked steps from the weights drawn
again, on the same batches.
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from .. import compare, costs, harness, tracing

# set before the card starts (run.py): read when cuBLAS starts, and when the caching allocator
# starts (segments that grow in place do not split); as ``launch/train.py`` sets them on a card
ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8", "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
NUMBERS = ("loss_gap", "grad_gap", "change_gap")  # what check gives
SMALL = {"batch": 2, "seq_len": 16}  # the shape at a CPU test's size (at most the cell's batch)


def make_step(cfg, opt: dict):
    """The timed path: the port's train step and AdamW."""
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.steps import make_train_step

    return make_train_step(cfg, AdamW(lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                                      weight_decay=opt["weight_decay"], max_grad_norm=opt["max_grad_norm"],
                                      moment_dtype=cfg.opt_moment_dtype))


def init_state(cfg, params: dict) -> dict:
    from repro_torch.optim.adamw import AdamW

    return AdamW(moment_dtype=cfg.opt_moment_dtype).init(params)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def leaf_norms(cfg, tree: dict, scale: float = 1.0) -> dict:
    """{leaf name: fp32 norm} of a tree shaped as the parameters, each
    stacked leaf per layer (``harness.layer_slices``); norms stay on the
    device until read."""
    out = {}
    for path, leaf in harness.flat_leaves(tree):
        for name, t in harness.layer_slices(cfg, path, leaf):
            out[short(name)] = t.float().norm() * scale
    return out


def short(name: str) -> str:
    """``L3/attn/wq`` -> ``L3/wq``: the reference's leaf names."""
    return name if not name.startswith("L") else f"{name.split('/', 1)[0]}/{name.rsplit('/', 1)[-1]}"


def run(r: harness.Run) -> harness.Outcome:
    t, conf = r.cell.traffic, r.cell.config
    cfg = harness.model_config(conf)
    b, s, opt = t["batch"], t["seq_len"], t["optimizer"]
    dev = r.device
    if dev.type == "cuda":  # deterministic algorithms, as ``launch/train.py`` trains on a card
        torch.use_deterministic_algorithms(True)
    t_weights = time.perf_counter()
    params = harness.make_weights(cfg, r.seed, dev)
    state = init_state(cfg, params)
    _sync(dev)
    t_steps = time.perf_counter()
    step = make_step(cfg, opt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(harness.sub_seed(r.seed, "batches"))

    def batch():
        return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev, dtype=torch.int32)}

    losses, grad1, change = [], None, {}
    for i in range(t["checked_steps"]):
        params, state, m = step(params, state, batch())
        losses.append(m["loss"])
        if i == 0:
            with torch.no_grad():  # the weights require grad: a norm taken with grad on keeps a graph of them
                grad1 = leaf_norms(cfg, state["m"], 1.0 / (1.0 - opt["b1"]))
    with torch.no_grad():
        for path, p0 in harness.iter_weights(cfg, r.seed, dev):
            leaf = params
            for key in path.strip("/").split("/"):
                leaf = leaf[key]
            for (name, now), (_, was) in zip(harness.layer_slices(cfg, path, leaf),
                                             harness.layer_slices(cfg, path, p0)):
                change[short(name)] = (now.float() - was.float()).norm()
            del p0, leaf, now, was
    prog = {"losses": [x.item() for x in losses], "grad1": {k: v.item() for k, v in grad1.items()},
            "change": {k: v.item() for k, v in change.items()}}
    info = {"flops_per_step": costs.train_flops(conf, b, s), "tokens_per_step": b * s,
            "attn": {"b": b, "s": s, **costs.attention_shape(conf), "elem_bytes": 2}}
    n_trace = t["trace_steps"] if r.trace else 0
    prof = tracing.Profiler() if n_trace else None
    _sync(dev)
    t_start = time.perf_counter()
    setup_s = t_start - r.t0
    print(f"setup: {t_weights - r.t0:.3f} s to the weights, {t_steps - t_weights:.3f} s weights and moments, "
          f"{t_start - t_steps:.3f} s the {t['checked_steps']} checked steps and their readings", file=sys.stderr)
    n, traced_s, window_s = 0, None, 0.0
    if prof:
        prof.start()
    while not r.readings:
        params, state, m = step(params, state, batch())
        _sync(dev)
        n += 1
        t2 = time.perf_counter()
        if n == n_trace:
            prof.stop()
            traced_s = t2 - t_start
            untraced_from = time.perf_counter() - t_start  # the profiler's stop gathers its events: not a step
        if t2 - t_start >= r.seconds and n >= n_trace:
            window_s = t2 - t_start
            break
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out = harness.Outcome(attempted=n, memory_peak_bytes=peak)
    if r.trace:
        info.update(run_steps=n - n_trace, run_window_s=window_s - untraced_from)
        out.trace = prof.trace("train", n_trace, traced_s, info)
    elif not r.readings:
        out.metrics = {"setup_s": setup_s, "train_tokens_per_s": n * b * s / window_s}
    del params, state, m, step
    out.numbers, out.variant_numbers = check(r, cfg, prog)
    return out


def check(r: harness.Run, cfg, prog: dict) -> tuple[dict, dict]:
    """(the program's numbers, each variant's): the reference's checked steps
    from the weights drawn again, on the same batches, against ``prog`` and
    against each of ``r.variants`` run in its place."""
    t, conf = r.cell.traffic, r.cell.config
    torch.use_deterministic_algorithms(False)  # the reference's sums need no fixed order
    gc.collect()  # a step's tensors can sit in reference cycles until a collection
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
        print(f"check: {torch.cuda.memory_allocated(r.device) / 2**30:.3f} GiB held before the reference",
              file=sys.stderr)
    ref_mod = harness.reference(conf["family"])
    opt = {**t["optimizer"], "no_decay": t["no_decay"]}
    gen = torch.Generator(device=r.device)
    gen.manual_seed(harness.sub_seed(r.seed, "batches"))
    batches = [torch.randint(0, cfg.vocab_size, (t["batch"], t["seq_len"]), generator=gen, device=r.device,
                             dtype=torch.int32) for _ in range(t["checked_steps"])]

    def weights():
        return harness.layers(cfg, harness.make_weights(cfg, r.seed, r.device))

    ref = ref_mod.train(weights, batches, conf, opt)
    runs = {"control": {"precision": "fp8"}, "half_batch": {"half_batch": True}}
    return compare.train_numbers(prog, ref), {
        v: compare.train_numbers(ref_mod.train(weights, batches, conf, opt, **runs[v]), ref) for v in r.variants}
