"""The bf16 Mamba selective-scan and RWKV6 WKV kernels' arithmetic, emulated
in plain PyTorch on the CPU, against the JAX package.

``csrc/mamba.cu``'s bf16 kernel pre-scales A by log2(e), takes each decay as
one ``ex2.approx.ftz`` on the SFU and updates with fused multiply-adds:
h = fma(e, h, dtu B[n]), y summed in four partial sums. ``emulate_mamba``
repeats that rounding: exp2 with results below 2^-126 flushed to zero in
place of ``ex2.approx.ftz``, each fma as one fp64 product and sum rounded
once to fp32, and the kernel's order of the y sum.

``csrc/rwkv6.cu``'s bf16 kernel runs the chunked closed form (L = 16) on
the tensor cores with every fp32 operand split into a bf16 hi + lo pair.
``emulate_wkv`` repeats those roundings per chunk (bf16 operands, fp32
accumulation, the zero-filled tail chunk). The kernel scans the cumsum of
logw in blocks of a few steps; both are fp32 sums of the same terms.

These tests show here, without the card, that the rounding stays inside the
bf16 bars of tests/test_kernels.py (y / out 2e-2, WKV state 3e-3, Mamba h
1e-3) at S=512, the serving length, and at ragged lengths, and that plain
bf16 operands in the WKV products would not. The CUDA kernels themselves
are held against their plain versions on the card by tests/test_torch_gpu.py
and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402

LOG2E = np.float32(1.4426950408889634)
OUT_TOL = dict(rtol=2e-2, atol=2e-2)  # tests/test_kernels.py:24, bf16
WKV_STATE_TOL = dict(rtol=3e-3, atol=3e-3)  # tests/test_kernels.py:110-111, bf16
MAMBA_STATE_TOL = dict(rtol=1e-3, atol=1e-3)  # tests/test_kernels.py:144-145
FLT_MIN = 2.0**-126  # ex2.approx.ftz flushes results below it to zero


def fma32(a, b, c):
    """fmaf: one fp64 product and sum, rounded once to fp32 (exact for fp32
    inputs but for double rounding, which these tests cannot see)."""
    return (a.double() * b.double() + c.double()).float()


def emulate_mamba(u, dt, A, B_, C_, h0=None):
    """u, dt [B,S,Di], B_, C_ [B,S,St] in bf16; A [Di,St] fp32 -> (y bf16, h
    fp32) with the bf16 kernel's arithmetic."""
    b, s, di = u.shape
    st = A.shape[1]
    a2 = A.float() * LOG2E
    h = torch.zeros(b, di, st) if h0 is None else h0.float().clone()
    u32, dt32, b32, c32 = (t.float() for t in (u, dt, B_, C_))
    ys = []
    for t in range(s):
        dtk = dt32[:, t, :, None]
        dtu = dt32[:, t] * u32[:, t]
        e = torch.exp2(dtk * a2[None])
        e = torch.where(e < FLT_MIN, torch.zeros_like(e), e)
        h = fma32(e, h, dtu[..., None] * b32[:, t, None, :])
        yp = [torch.zeros(b, di) for _ in range(4)]
        for n in range(st):
            yp[n % 4] = fma32(h[..., n], c32[:, t, None, n].expand(b, di), yp[n % 4])
        ys.append((yp[0] + yp[1]) + (yp[2] + yp[3]))
    return torch.stack(ys, dim=1).to(u.dtype), h


def _bf(x):
    return x.bfloat16().float()


def _split(x):
    hi = _bf(x)
    return hi, _bf(x - hi)


def emulate_wkv(r, k, v, logw, u, state0=None, hi_lo=True):
    """r, k, v, logw [B,S,H,Dh] bf16; u [H,Dh]; state0 [B,H,Dh,Dh] fp32 ->
    (out bf16, state fp32) with the bf16 kernel's arithmetic: per chunk of
    16 steps, every fp32 operand of the four products as a bf16 hi + lo pair
    (three products for fp32 x fp32, two against v), fp32 accumulation.
    ``hi_lo=False`` rounds each fp32 operand to bf16 once instead."""
    b, s, h, d = r.shape
    n = -(-s // 16)
    pad = n * 16 - s  # the tail chunk is zero-filled: logw = 0, r = k = v = 0

    def chunks(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(b, n, 16, h, d).permute(1, 0, 3, 2, 4)  # [n, B, H, 16, Dh]

    def mm(x, y, y_exact=False):
        """x @ y with x (and y unless exact in bf16) as bf16 operands."""
        if not hi_lo:
            return _bf(x) @ (y if y_exact else _bf(y))
        xh, xl = _split(x)
        if y_exact:
            return xh @ y + xl @ y
        yh, yl = _split(y)
        return xh @ yh + (xh @ yl + xl @ yh)

    S = torch.zeros(b, h, d, d) if state0 is None else state0.float().clone()  # [i][j]
    u32 = u.float()[None, :, None, :]
    tri = torch.tril(torch.ones(16, 16), diagonal=-1)
    outs = []
    for rc, kc, vc, lwc in zip(*(chunks(x) for x in (r, k, v, logw))):
        la = torch.cumsum(lwc * LOG2E, dim=2)  # log2 units
        prev = torch.cat([torch.zeros_like(la[:, :, :1]), la[:, :, :-1]], dim=2)
        last = la[:, :, -1:]
        q = rc * torch.exp2(prev)
        kk = kc * torch.exp2(-la)
        kd = kc * torch.exp2(last - la)
        bonus = (rc * u32 * kc).sum(-1)
        scores = mm(q, kk.transpose(-1, -2)) * tri + torch.diag_embed(bonus)
        outs.append(mm(S.transpose(-1, -2), q.transpose(-1, -2)).transpose(-1, -2)
                    + mm(scores, vc, y_exact=True))
        S = S * torch.exp2(last[:, :, 0])[..., None] + mm(kd.transpose(-1, -2), vc, y_exact=True)
    out = torch.stack(outs, dim=2).reshape(b, h, n * 16, d)[:, :, :s].transpose(1, 2)
    return out.to(r.dtype), S


# ------------------------------------------------------------------ inputs
def _pair(x, dtype):
    j = jnp.asarray(x, dtype)
    return j, tensor_from_numpy(np.asarray(j), torch.device("cpu"))


def _mamba_inputs(shape, seed=3, dt_scale=0.1):
    """tests/test_kernels.py:133-139's inputs in bf16: u, B, C ~ N(0, 1),
    dt = dt_scale |N(0, 1)| (0.1 there), A = -|N(0, 1)| fp32, h0 ~ N(0, 0.3) fp32."""
    b, s, di, st = shape
    rng = np.random.default_rng(seed)
    u = _pair(rng.normal(0, 1, (b, s, di)), jnp.bfloat16)
    dt = _pair(np.abs(rng.normal(0, 1, (b, s, di))) * dt_scale, jnp.bfloat16)
    A = _pair(-np.abs(rng.normal(0, 1, (di, st))), jnp.float32)
    B_ = _pair(rng.normal(0, 1, (b, s, st)), jnp.bfloat16)
    C_ = _pair(rng.normal(0, 1, (b, s, st)), jnp.bfloat16)
    h0 = _pair(rng.normal(0, 0.3, (b, di, st)), jnp.float32)
    return [x[0] for x in (u, dt, A, B_, C_, h0)], [x[1] for x in (u, dt, A, B_, C_, h0)]


def _wkv_inputs(shape, seed=42, clamp_chunk=None):
    """tests/test_kernels.py:97-103's inputs in bf16: r, k, v ~ N(0, 1),
    logw = -|N(0, 1)| - 0.05 (-MAX_DECAY over chunk ``clamp_chunk``), u fp32,
    state0 ~ N(0, 0.3) fp32."""
    b, s, h, dh = shape
    rng = np.random.default_rng(seed)
    r, k, v = (_pair(rng.normal(0, 1, shape), jnp.bfloat16) for _ in range(3))
    lw = -np.abs(rng.normal(0, 1, shape)) - 0.05
    if clamp_chunk is not None:
        lw[:, 16 * clamp_chunk : 16 * clamp_chunk + 16] = -4.0  # models/ssm.py MAX_DECAY
    logw = _pair(lw, jnp.bfloat16)
    u = _pair(rng.normal(0, 1, (h, dh)), jnp.float32)
    s0 = _pair(rng.normal(0, 0.3, (b, h, dh, dh)), jnp.float32)
    return [x[0] for x in (r, k, v, logw, u, s0)], [x[1] for x in (r, k, v, logw, u, s0)]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------------- mamba
# tests/test_kernels.py:130 and the serving length at a few channels, each at
# that file's dt scale and at one ten times smaller, whose decays stay within
# ~1% of 1, so the state remembers the whole sequence and rounding gathers.
MAMBA_SHAPES = [(2, 64, 64, 8), (1, 128, 256, 16), (1, 512, 32, 16)]


@pytest.mark.parametrize("dt_scale", [0.1, 0.01])
@pytest.mark.parametrize("shape", MAMBA_SHAPES)
def test_mamba_emulation_matches_jax_kernel_and_reference(shape, dt_scale):
    jargs, targs = _mamba_inputs(shape, dt_scale=dt_scale)
    y, h = emulate_mamba(*targs)
    for want_y, want_h in (jax_ops.mamba_scan(*jargs, True), jax_ref.mamba_ref(*jargs)):
        _close(y, want_y, OUT_TOL)
        _close(h, want_h, MAMBA_STATE_TOL)


@pytest.mark.parametrize("s", [40, 17])
def test_mamba_emulation_at_ragged_lengths_matches_jax_reference(s):
    """From a zero state, as prefill calls it; the Pallas kernel takes only
    multiples of its 64-step chunk, so these are held against the reference."""
    jargs, targs = _mamba_inputs((2, s, 96, 16), seed=4)
    jargs[5] = jnp.zeros_like(jargs[5])
    y, h = emulate_mamba(*targs[:5], None)
    want_y, want_h = jax_ref.mamba_ref(*jargs)
    _close(y, want_y, OUT_TOL)
    _close(h, want_h, MAMBA_STATE_TOL)


def test_mamba_emulation_with_decays_that_flush_to_zero_matches_jax_kernel_and_reference():
    """dt up to a few hundred: many dt A log2(e) fall below -126, where
    ex2.approx.ftz gives 0 and exact exp2 a subnormal (or 0 below -149)."""
    jargs, targs = _mamba_inputs((1, 64, 64, 16), seed=7, dt_scale=100.0)
    x = targs[1].float()[..., None] * (targs[2].float() * LOG2E)
    assert int(((x < -126) & (x > -149)).sum()) > 1000
    y, h = emulate_mamba(*targs)
    for want_y, want_h in (jax_ops.mamba_scan(*jargs, True), jax_ref.mamba_ref(*jargs)):
        _close(y, want_y, OUT_TOL)
        _close(h, want_h, MAMBA_STATE_TOL)


# ------------------------------------------------------------------- rwkv6
# tests/test_kernels.py:94-95 and the serving length at two heads of 64.
WKV_SHAPES = [(2, 64, 2, 32), (1, 128, 4, 64), (1, 32, 1, 128), (1, 512, 2, 64)]


@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv_emulation_matches_jax_kernel_and_reference(shape):
    jargs, targs = _wkv_inputs(shape)
    out, state = emulate_wkv(*targs)
    for want_out, want_state in (jax_ops.rwkv6(*jargs, True), jax_ref.rwkv6_ref(*jargs)):
        _close(out, want_out, OUT_TOL)
        _close(state, want_state, WKV_STATE_TOL)


def test_wkv_emulation_with_logw_at_the_clamp_matches_jax_kernel_and_reference():
    """A whole chunk at -MAX_DECAY: e^(-la) reaches e^64 inside the chunk."""
    jargs, targs = _wkv_inputs((1, 64, 2, 64), seed=5, clamp_chunk=1)
    out, state = emulate_wkv(*targs)
    for want_out, want_state in (jax_ops.rwkv6(*jargs, True), jax_ref.rwkv6_ref(*jargs)):
        _close(out, want_out, OUT_TOL)
        _close(state, want_state, WKV_STATE_TOL)


@pytest.mark.parametrize("s", [40, 17])
def test_wkv_emulation_at_ragged_lengths_matches_jax_reference(s):
    """A zero-filled tail chunk, from a zero state; the Pallas kernel takes
    only multiples of its 16-step chunk, so these are held against the reference."""
    jargs, targs = _wkv_inputs((2, s, 4, 16), seed=6)
    jargs[5] = jnp.zeros_like(jargs[5])
    out, state = emulate_wkv(*targs[:5], None)
    want_out, want_state = jax_ref.rwkv6_ref(*jargs)
    _close(out, want_out, OUT_TOL)
    _close(state, want_state, WKV_STATE_TOL)


def test_wkv_with_plain_bf16_operands_would_break_the_bars():
    """Why the kernel splits every fp32 operand: rounded to bf16 once, q_,
    k_, the scores, S and kd miss both bars at the serving length."""
    jargs, targs = _wkv_inputs((1, 512, 2, 64))
    out, state = emulate_wkv(*targs, hi_lo=False)
    want_out, want_state = (np.asarray(x, np.float32) for x in jax_ref.rwkv6_ref(*jargs))

    def excess(got, want, tol):
        return float((np.abs(got.float().numpy() - want) / (tol["atol"] + tol["rtol"] * np.abs(want))).max())

    assert excess(out, want_out, OUT_TOL) > 1
    assert excess(state, want_state, WKV_STATE_TOL) > 1
