"""The emission loop's one-query attention (``ops/decode_attention``, K7 on
the card) on the CPU, where the wrapper runs its plain version.

- With row bounds and a plane, the plain version equals the whole-cache
  code the emission loop ran before (every row read, ``MASK_VALUE`` on the
  hidden ones) within 1e-6, at the four call sites' layouts, on caches
  whose hidden rows hold large values: the rows left out weigh exactly 0.
- A stream with no loaded row, or none the plane shows, gets zeros (never
  NaN), and a free serving slot, which loads nothing, never emits.
- The wrapper raises on a wrong dtype, shape or stride, on every device.
- ``ServingSession``, which hands the jointer each slot's extent, gives the
  texts and delays of the same session reading the whole plane and of the
  cached decoder run alone on each stream, across compaction and slot
  reuse.
- ``serving.jointer_rows_loaded`` equals a hand count: the sum of the
  occupied slots' extents, once a step.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.test_torch_port_serving import (SCENARIOS, SESSION_KW, W2V,
                                           _vocab, clips, models, oracle)
from wav2vec_s_tpu_torch.data.dictionary import Dictionary
from wav2vec_s_tpu_torch.ops.block_mask import MASK_VALUE
from wav2vec_s_tpu_torch.ops.decode_attention import decode_attention
from wav2vec_s_tpu_torch.stream import caat_step
from wav2vec_s_tpu_torch.stream.serving import ServingSession
from wav2vec_s_tpu_torch.utils import debug

N, T, H, DH = 5, 40, 3, 8
D = H * DH


def _whole_cache(q, k, v, seen, n_heads):
    """The emission loop's attention before K7: logits in f32 over every
    row, ``MASK_VALUE`` where ``seen`` [N, T] is False, p cast to q's
    dtype before P.V."""
    T_, N_, D_ = k.shape
    Dh = D_ // n_heads
    qh = q.reshape(N_, n_heads, Dh).float()
    kh = k.reshape(T_, N_, n_heads, Dh).float()
    vh = v.reshape(T_, N_, n_heads, Dh)
    logits = torch.einsum("nhd,tnhd->nht", qh, kh) * (Dh ** -0.5)
    bias = torch.where(seen, 0.0, MASK_VALUE)
    p = torch.softmax(logits + bias[:, None, :], dim=-1).to(q.dtype)
    return torch.einsum("nht,tnhd->nhd", p, vh).reshape(N_, D_)


def _layout(name, rng):
    """(lo, hi, plane, the rows each stream sees [N, T]) of a call site."""
    t = np.arange(T)[None]
    if name == "serving_jointer":        # slot extents + the plane, hi 0-d
        lo = np.array([0, 7, 13, 30, 2])
        hi = np.array(36)
        plane = (rng.random((N, T)) < 0.5) & (t >= lo[:, None]) & (t < hi)
        plane[:, 35] = True
        plane |= rng.random((N, T)) < 0.2        # stale rows outside too
        seen = plane & (t >= lo[:, None]) & (t < hi)
    elif name == "decoder_jointer":      # hi = visible, lo = 0
        lo, plane = None, None
        hi = np.array([1, 12, 12, 40, 25])
        seen = t < hi[:, None]
    elif name == "slot_lm":              # hi = ptr + 1, plane = valid.T
        lo = None
        hi = np.array(23)
        plane = rng.random((N, T)) < 0.6
        plane[:, 0] = True
        plane[:, 23:] = False
        seen = plane.copy()
    else:                                # "lm": hi = index + 1
        lo, plane = None, None
        hi = np.array([1, 2, 9, 40, 17])
        seen = t < hi[:, None]
    as_t = (lambda a: None if a is None else torch.from_numpy(a))
    return (as_t(lo), as_t(hi), as_t(plane), torch.from_numpy(seen))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["serving_jointer", "decoder_jointer",
                                    "slot_lm", "lm"])
def test_plain_version_equals_the_whole_cache_code(layout, dtype):
    rng = np.random.default_rng(1)
    lo, hi, plane, seen = _layout(layout, rng)
    q = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((T, N, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((T, N, D)).astype(np.float32))
    hidden = ~seen.T[:, :, None]                   # [T, N, 1]
    k = torch.where(hidden, 40.0 * k, k)           # large logits ...
    v = torch.where(hidden, 1e3 * v, v)            # ... over large values
    if layout == "slot_lm":                        # the plane as the LM
        plane = plane.T.contiguous().T             # hands it: valid.T
    q, k, v = (x.to(dtype).contiguous() for x in (q, k, v))
    got = decode_attention(q, k, v, H, lo=lo, hi=hi, plane=plane)
    want = _whole_cache(q, k, v, seen, H)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=1e-6, rtol=0)


def test_stream_with_no_loaded_row_gives_zeros_and_never_emits(monkeypatch):
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((T, N, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((T, N, D)).astype(np.float32))
    lo = torch.tensor([5, 0, 10, 40, 3])
    hi = torch.tensor([5, 20, 30, 40, 0])           # 0, 3, 4: no row
    plane = torch.ones((N, T), dtype=torch.bool)
    plane[1] = False                                # 1: no row it sees
    out = decode_attention(q, k, v, H, lo=lo, hi=hi, plane=plane)
    assert torch.isfinite(out).all()
    assert (out[[0, 1, 3, 4]] == 0).all()
    seen = torch.zeros((N, T), dtype=torch.bool)
    seen[2, 10:30] = True
    np.testing.assert_allclose(out[2].numpy(),
                               _whole_cache(q, k, v, seen, H)[2].numpy(),
                               atol=1e-6)
    # a free slot of a session loads no row: finite log-probs, no emission
    want = oracle()["s1"]
    sess = ServingSession(models()[2], _vocab(Dictionary), W2V, n_slots=2,
                          t_cap=128, **SESSION_KW)
    jointer_step, free_rows = caat_step.jointer_step, []

    def watched(*args):
        lp = jointer_step(*args)
        _, lo, hi = args[-1]
        free_rows.append((int(hi - lo[1]), bool(torch.isfinite(lp[1]).all())))
        return lp

    monkeypatch.setattr(caat_step, "jointer_step", watched)
    assert sess.add_stream("s1")
    sess.push("s1", clips()["s1"], is_end=True)
    sess.drain()
    assert free_rows and all(r == (0, True) for r in free_rows)
    assert sess.result("s1") == want
    assert int(sess._lens[1]) == 1


def _qkv(dtype=torch.float32, n=N, t=T, d=D):
    return (torch.zeros((n, d), dtype=dtype), torch.zeros((t, n, d)),
            torch.zeros((t, n, d)))


def _bad(case):
    """(args, kwargs) of a call the wrapper refuses."""
    q, k, v = _qkv()
    kw = {}
    if case == "q_float16":
        q = q.half()
    elif case == "cache_dtype":
        k = k.bfloat16()
    elif case == "cache_shape":
        k = torch.zeros((T, N + 1, D))
    elif case == "v_shape":
        v = torch.zeros((T + 1, N, D))
    elif case == "cache_stride":
        k = torch.zeros((N, T, D)).transpose(0, 1)
    elif case == "q_stride":
        q = torch.zeros((N, 2 * D))[:, ::2]
    elif case == "plane_shape":
        kw["plane"] = torch.ones((T, N), dtype=torch.bool)
    elif case == "plane_dtype":
        kw["plane"] = torch.ones((N, T), dtype=torch.uint8)
    elif case == "hi_dtype":
        kw["hi"] = torch.zeros(N, dtype=torch.int32)
    elif case == "lo_shape":
        kw["lo"] = torch.zeros(N + 1, dtype=torch.int64)
    elif case == "heads":
        return (q, k, v, 5), kw
    elif case == "head_width":
        q, k, v = _qkv(d=256)
        return (q, k, v, 1), kw
    return (q, k, v, H), kw


@pytest.mark.parametrize("case", [
    "q_float16", "cache_dtype", "cache_shape", "v_shape", "cache_stride",
    "q_stride", "plane_shape", "plane_dtype", "hi_dtype", "lo_shape",
    "heads", "head_width"])
def test_wrapper_raises_on_a_wrong_dtype_shape_or_stride(case):
    args, kw = _bad(case)
    with pytest.raises(ValueError):
        decode_attention(*args, **kw)
    decode_attention(*_qkv(), H)                   # the good call runs


def _drive(scenario, extents: bool, monkeypatch):
    drive, n_slots, t_cap = SCENARIOS[scenario]
    sess = ServingSession(models()[2], _vocab(Dictionary), W2V,
                          n_slots=n_slots, t_cap=t_cap, **SESSION_KW)
    with monkeypatch.context() as m:
        if not extents:                 # the whole plane, as before
            jointer_step = caat_step.jointer_step

            def whole(*args):
                vis, lo, hi = args[-1]
                return jointer_step(*args[:-1], caat_step.SlotPlane(
                    vis, torch.zeros_like(lo), torch.full_like(
                        hi, vis.shape[1])))

            m.setattr(caat_step, "jointer_step", whole)
        drive(sess, clips())
    return sess


@pytest.mark.parametrize("scenario", ["compaction", "stagger_stall_recycle"])
def test_session_with_extents_equals_whole_plane_reads(monkeypatch,
                                                       scenario):
    """``compaction``: three streams one after another on one slot of a
    cache too small for them (two reuses, compactions); the other: a stall
    and a recycled slot on two slots."""
    cut = _drive(scenario, True, monkeypatch)
    whole = _drive(scenario, False, monkeypatch)
    assert (cut.compactions > 0) == (scenario == "compaction")
    assert cut.compactions == whole.compactions
    for sid, want in oracle().items():
        assert cut.result(sid) == whole.result(sid) == want, sid


def test_jointer_rows_loaded_equals_a_hand_count(monkeypatch):
    """One stream of 5 chunks on one slot: step k (from 0) loads rows
    [0, 6 (k + 1)), 6 = main + look-ahead rows a step, so 6 x 15 rows;
    then the stall-and-recycle scenario against the occupied slots'
    extents summed from the host's state at each device step."""
    debug.reset_counters()
    sess = ServingSession(models()[2], _vocab(Dictionary), W2V, n_slots=1,
                          t_cap=128, **SESSION_KW)
    assert sess._rows_per_step == 6
    with profile(activities=[ProfilerActivity.CPU]):
        assert sess.add_stream("s2")
        sess.push("s2", clips()["s2"], is_end=True)
        sess.drain()
    c = debug.counters()
    assert sess.steps == 5
    assert c["serving.jointer_rows_loaded"] == 6 * (1 + 2 + 3 + 4 + 5)
    assert c["serving.plane_rows_read"] == 5 * 128

    debug.reset_counters()
    drive, n_slots, t_cap = SCENARIOS["stagger_stall_recycle"]
    sess = ServingSession(models()[2], _vocab(Dictionary), W2V,
                          n_slots=n_slots, t_cap=t_cap, **SESSION_KW)
    hand, device_step = [], sess._device_step

    def counted(*args):
        t_end = sess._estate.t_main + sess._rows_per_step
        hand.append(sum(t_end - s.first_row for s in sess.slots
                        if s.stream_id is not None))
        return device_step(*args)

    monkeypatch.setattr(sess, "_device_step", counted)
    with profile(activities=[ProfilerActivity.CPU]):
        drive(sess, clips())
    c = debug.counters()
    debug.reset_counters()
    assert c["serving.jointer_rows_loaded"] == sum(hand)
    assert (c["serving.plane_rows_visible"] < c["serving.jointer_rows_loaded"]
            < c["serving.plane_rows_read"])
