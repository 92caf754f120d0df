"""A closed loop of prompt phases: one client sends a batch of ``batch``
prompts of ``prompt_len`` tokens and waits for the first token of each,
through the port's ``make_prefill_step`` (the KV cache of the prompt and
the last position's logits) and ``greedy_token``; then sends the next.

Set-up makes the weights and warms up one prompt phase of the cell's own
shape. The window runs back to back until ``--seconds`` have
passed, and ends at the first batch that completes after that: every
batch sent in it counts, over all of its time. Time to first token is each
batch's, from its prefill call to its tokens on the host (``.cpu()`` waits
for the card). With ``--trace 1`` the profiler covers the window's first
``trace_steps`` batches.

``correct``: the window's batches at ``sample_batches`` places drawn from
the seed among the first ``SAMPLE_SPAN`` (the loop runs on past the window,
untimed, until they are done) keep their prompts and the port's outputs:
the cache, the logits and the tokens. Once the window has closed and the
peak memory is read, the port's state is dropped and the reference runs
over each kept prompt, and ``compare.prompt_numbers`` judges the outputs.
"""
from __future__ import annotations

import gc
import random
import sys
import time

import torch

from .. import compare, costs, harness, tracing

WARMUP = 1  # prompt phases run in set-up: the cell's one shape
SAMPLE_SPAN = 30  # the sampled batches are drawn among the window's first SAMPLE_SPAN
NUMBERS = ("kv_err", "kv_tok_med", "logit_err", "logit_med", "token_gap", "served_gap")  # what check gives
SMALL = {"batch": 2, "prompt_len": 24}  # the shape at a CPU test's size (at most the cell's batch)


def make_step(cfg, cache_len: int):
    """The timed path: the port's prefill step and greedy first token."""
    from repro_torch.train.steps import greedy_token, make_prefill_step

    prefill = make_prefill_step(cfg, cache_len=cache_len)

    def step(params, tokens):
        caches, logits = prefill(params, {"tokens": tokens})
        return caches, logits, greedy_token(cfg, logits)

    return step


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def caches_by_layer(cfg, caches: dict, name: str) -> list:
    """Each layer's ``name`` ("k" or "v") cache, in layer order, from the
    port's stacked decode state."""
    period = len(cfg.pattern)
    return [caches[f"p{layer % period}"][name][layer // period] for layer in range(cfg.n_layers)]


def run(r: harness.Run) -> harness.Outcome:
    t, conf = r.cell.traffic, r.cell.config
    cfg = harness.model_config(conf)
    b, s = t["batch"], t["prompt_len"]
    dev = r.device
    t_weights = time.perf_counter()
    params = harness.make_weights(cfg, r.seed, dev)
    step = make_step(cfg, s)
    _sync(dev)
    t_warm = time.perf_counter()

    def prompts(tag):
        gen = torch.Generator(device=dev)
        gen.manual_seed(harness.sub_seed(r.seed, tag))
        while True:
            yield torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev, dtype=torch.int32)

    warm = prompts("warmup")
    for _ in range(WARMUP):
        out = step(params, next(warm))
        out[2].cpu()
        del out
    # room for the kept batches' outputs, taken now: the allocator hands it out in the window
    # instead of asking the driver for memory there (a 6.4 GB cudaMalloc stalls a batch ~60 ms)
    kept_bytes = 2 * cfg.n_layers * b * s * cfg.n_kv_heads * cfg.head_dim * 2 + b * cfg.padded_vocab * 2
    room = torch.empty(t["sample_batches"] * kept_bytes, dtype=torch.uint8, device=dev)
    del room
    span = t["sample_batches"] if r.readings else SAMPLE_SPAN
    sample = set(random.Random(harness.sub_seed(r.seed, "sample")).sample(range(span), t["sample_batches"]))
    kept: dict[int, tuple] = {}
    feed = prompts("prompts")
    info = {"flops_per_step": costs.prefill_flops(conf, b, s), "tokens_per_step": b * s,
            "attn": {"b": b, "s": s, **costs.attention_shape(conf), "elem_bytes": 2}}
    n_trace = t["trace_steps"] if r.trace else 0
    prof = tracing.Profiler() if n_trace else None
    ttft: list[float] = []
    window_s = traced_s = None
    _sync(dev)
    t_start = time.perf_counter()
    setup_s = t_start - r.t0
    print(f"setup: {t_weights - r.t0:.3f} s to the weights, {t_warm - t_weights:.3f} s weights, "
          f"{t_start - t_warm:.3f} s warm-up", file=sys.stderr)
    i = 0
    if prof:
        prof.start()
    while window_s is None or i <= max(sample):
        tokens = next(feed)
        t1 = time.perf_counter()
        caches, logits, tok = step(params, tokens)
        tok = tok.cpu()
        t2 = time.perf_counter()
        if window_s is None:
            ttft.append(t2 - t1)
            if r.readings or (t2 - t_start >= r.seconds and i + 1 >= n_trace):
                window_s = t2 - t_start
        if i + 1 == n_trace:
            prof.stop()
            traced_s = t2 - t_start
            untraced_from = time.perf_counter() - t_start  # the profiler's stop gathers its events: not a step
        if i in sample:
            kept[i] = (tokens, caches, logits, tok)
        del caches, logits
        i += 1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n = len(ttft)
    out = harness.Outcome(attempted=n * b, memory_peak_bytes=peak)
    if r.trace:
        info.update(run_steps=n - n_trace, run_window_s=window_s - untraced_from)
        out.trace = prof.trace("prompt", n_trace, traced_s, info)
    else:
        ttft.sort()
        out.metrics = {"setup_s": setup_s, "serve_tokens_per_s": n * b * s / window_s,
                       "ttft_p90_ms": 1e3 * _percentile(ttft, 0.90), "ttft_p50_ms": 1e3 * _percentile(ttft, 0.5)}
    del step
    out.numbers, out.variant_numbers = check(r, cfg, params, kept)
    return out


def _percentile(sorted_values: list[float], q: float) -> float:
    """The q-quantile by linear interpolation between closest ranks."""
    x = (len(sorted_values) - 1) * q
    lo = int(x)
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (x - lo)


def check(r: harness.Run, cfg, params: dict, kept: dict) -> tuple[dict, dict]:
    """(the program's numbers over the kept batches, each variant's): with
    ``control`` in ``r.variants`` also the fp8 reference's outputs on the
    same prompts, judged as the program's are (its served token the argmax
    of its own last logits)."""
    conf = r.cell.config
    ref_mod = harness.reference(conf["family"])
    weights = harness.layers(cfg, params)
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, control = [], []
    for i in sorted(kept):
        tokens, caches, logits, tok = kept.pop(i)
        k, v = caches_by_layer(cfg, caches, "k"), caches_by_layer(cfg, caches, "v")
        ref = ref_mod.prefill(weights, tokens, conf)
        numbers.append(compare.prompt_numbers(k, v, logits, tok.to(tokens.device), ref, cfg.vocab_size,
                                              cfg.sliding_window))
        del caches, logits, tok, k, v
        if "control" in r.variants:
            low = ref_mod.prefill(weights, tokens, conf, precision="fp8")
            control.append(compare.prompt_numbers(low["k"], low["v"], low["last_logits"],
                                                  low["last_logits"].argmax(dim=-1, keepdim=True), ref,
                                                  cfg.vocab_size, cfg.sliding_window))
            del low
        del ref
    return compare.merge_prompt(numbers), ({"control": compare.merge_prompt(control)} if control else {})
