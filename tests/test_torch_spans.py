"""The port's program spans (``repro_torch/spans.py``) on the CPU at smoke
size: each span is entered as often as the step's structure says while a
profiler runs, and no span calls ``record_function`` while none runs."""
from collections import Counter
from contextlib import nullcontext

import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs, spans  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.moe import COMBINE, DISPATCH, EXPERTS  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train.steps import make_prefill_step, make_train_step  # noqa: E402

B, S = 2, 16
NEW = (spans.TRAIN_FORWARD, spans.ADAMW_UPDATE, spans.BLOCK_ATTENTION, spans.BLOCK_FFN, spans.PREFILL_KV_CACHE)


def _model(arch, **change):
    cfg = configs.get_smoke(arch).replace(**change)
    params = init_params(T.param_defs(cfg), seed=0, dtype=torch.float32, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(0), dtype=torch.int32)
    return cfg, params, {"tokens": tokens}


def _train_step(cfg, params, batch):
    opt = AdamW()
    make_train_step(cfg, opt)(params, opt.init(params), batch)


def _prefill(cfg, params, batch):
    make_prefill_step(cfg, cache_len=S)(params, batch)


def _spans_entered(fn, *args) -> Counter:
    """{name: times entered} of the spans ``fn(*args)`` enters under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    return Counter(e.name for e in prof.events() if e.name in NEW + (DISPATCH, EXPERTS, COMBINE))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_spans(microbatches):
    cfg, params, batch = _model("qwen3_0_6b", remat=True, microbatches=microbatches)
    got = _spans_entered(_train_step, cfg, params, batch)
    # remat: each block runs in the forward and again in the backward's recompute
    blocks = 2 * cfg.n_layers * microbatches
    assert got == {spans.TRAIN_FORWARD: microbatches, spans.ADAMW_UPDATE: 1,
                   spans.BLOCK_ATTENTION: blocks, spans.BLOCK_FFN: blocks}


def test_prefill_spans():
    cfg, params, batch = _model("qwen3_0_6b")
    got = _spans_entered(_prefill, cfg, params, batch)
    # the cache: built once a layer, then stacked once a pattern position
    assert got == {spans.BLOCK_ATTENTION: cfg.n_layers, spans.BLOCK_FFN: cfg.n_layers,
                   spans.PREFILL_KV_CACHE: cfg.n_layers + len(cfg.pattern)}


def test_moe_prefill_spans():
    cfg, params, batch = _model("mixtral_8x22b")
    moe_layers = sum(kind.moe for kind in cfg.pattern) * cfg.n_repeats
    assert moe_layers > 0
    got = _spans_entered(_prefill, cfg, params, batch)
    assert got[DISPATCH] == 2 * moe_layers and got[EXPERTS] == moe_layers and got[COMBINE] == moe_layers
    assert got[spans.BLOCK_FFN] == cfg.n_layers


def test_spans_do_not_record_without_a_profiler(monkeypatch):
    calls = []

    def counting(name):
        calls.append(name)
        return nullcontext()

    monkeypatch.setattr(spans, "record_function", counting)
    train = _model("qwen3_0_6b", remat=True)
    moe = _model("mixtral_8x22b")
    _train_step(*train)
    _prefill(*train)
    _prefill(*moe)
    assert calls == []
    # the stand-in is the one the spans call: under a profiler it counts them
    with profile(activities=[ProfilerActivity.CPU]):
        _prefill(*moe)
    assert Counter(calls)[DISPATCH] > 0 and Counter(calls)[spans.BLOCK_ATTENTION] > 0
