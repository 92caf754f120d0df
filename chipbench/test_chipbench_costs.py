"""The yardstick's frozen formulas against numbers worked by hand."""
from __future__ import annotations

import json

import pytest

from chipbench import costs
from chipbench.small import ROOT


def conf(name):
    return json.loads((ROOT / "chipbench" / "configs" / f"{name}.json").read_text())


def test_attention_pairs_by_hand():
    assert costs.attention_pairs(4, 4) == 10  # 1 + 2 + 3 + 4
    assert costs.attention_pairs(3, 4, causal=False) == 12
    assert costs.attention_pairs(4, 4, window=2) == 7  # 1 + 2 + 2 + 2
    assert costs.attention_pairs(1024, 1024, window=2047) == 1024 * 1025 // 2  # a window that never binds
    assert costs.attention_pairs(8192, 8192, window=4096) == 4096 * 4097 // 2 + 4096 * 4096


def test_attention_flops_bytes_and_bound_by_hand():
    assert costs.attention_flops(2, 4, 4, 3, 16) == 4 * 16 * 10 * 2 * 3
    assert costs.attention_bytes(2, 4, 4, 6, 2, 16, 2) == 2 * (2 * 2 * 4 * 6 * 16 + 2 * 2 * 4 * 2 * 16)
    # phi3's train launch (8, 512, 32/32, Dh 96): 12.9 GFLOP, 100.7 MB: bound by bytes
    flops, byts = costs.attention_flops(8, 512, 512, 32, 96), costs.attention_bytes(8, 512, 512, 32, 32, 96, 2)
    assert flops == 4 * 96 * 131328 * 8 * 32 and byts == 100663296
    assert costs.attention_bound_s(8, 512, 512, 32, 32, 96, 2) == pytest.approx(byts / 3.35e12)
    # mixtral's full causal launch at 8,192 (1, 48/8, Dh 128): 825 GFLOP, bound by FLOPs
    assert costs.attention_bound_s(1, 8192, 8192, 48, 8, 128, 2) == pytest.approx(
        4 * 128 * 33558528 * 48 / 989e12)


def test_model_flops_by_hand():
    phi3 = conf("phi3-mini-3.8b")
    layer = 4 * 3072 * 3072 + 3 * 3072 * 8192  # q, k, v, o (MHA) and SwiGLU
    assert costs.layer_matrix_params(phi3) == layer
    attn = 4 * 96 * (512 * 513 // 2) * 8 * 32
    assert costs.train_flops(phi3, 8, 512) == 6 * (32 * layer + 3072 * 32064) * 4096 + 3 * 32 * attn
    assert costs.train_flops(phi3, 8, 512) == pytest.approx(92.63e12, rel=1e-3)
    mix = conf("mixtral-8x22b-8l")
    layer = 6144 * 6144 * 2 + 2 * 6144 * 1024 + 6144 * 8 + 2 * 3 * 6144 * 16384  # GQA, router, top-2 experts
    assert costs.layer_matrix_params(mix) == layer
    expect = 2 * layer * 8192 * 8 + 2 * 6144 * 32768 + 4 * 128 * (8192 * 8193 // 2) * 48 * 8
    assert costs.prefill_flops(mix, 1, 8192) == expect
    assert costs.prefill_flops(mix, 1, 8192) == pytest.approx(97.3e12, rel=2e-3)
