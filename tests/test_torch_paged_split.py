"""The paged kernel's split-K algorithm, pinned on the CPU.

The CUDA kernel (ops/kernels/paged_attn.cu) runs only on the card. Here a
plain torch model of what it computes -- the wrapper's own plan
(`ops.attention.paged_split_plan`), one CTA per (b, kv head, row tile,
split) that exits when its split starts past the largest frontier of its
rows, an online softmax over tiles inside the split (32 slots here; the
kernel's own tiling of a split does not change which partials exist),
partials (m, l, acc) into a workspace that starts as NaN, and a merge that reads,
for each row, only the splits that start at or before its frontier, in
split order -- is held against `paged_extend_reference` and against the
JAX package's reference and Pallas kernel (interpret mode), on the same
numpy inputs."""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas as pk
from paddle_tpu.quantization import observers as jobs
from paddle_tpu_torch.ops import attention as ta

TILE = 32  # cache slots of one tile of the kernel's ring (its widest)
SMS = 132  # an H100's SMs: the plans below are the ones that card gets
F32_TOL = dict(rtol=2e-5, atol=2e-5)  # f32 sums in another order; int8 scale*(1/127) vs /127


def kernel_merge_count(frontier, split_slots, n_splits):
    """The splits the merge reads for a row: those that start at or before
    its frontier."""
    return min(n_splits, max(frontier, 0) // split_slots + 1)


def split_model(q, kp, vp, bt, qpos, ks=None, vs=None, split_pages=None,
                merge_count=kernel_merge_count):
    """The kernel's algorithm in torch. Returns (out, stats): the plan, how
    many CTAs exited, and how many row partials were masked whole (written,
    but past their row's frontier: m = -1e30, p = 1 on masked slots)."""
    b, qn, h, d = q.shape
    n, bs, hkv, _ = kp.shape
    group, m = h // hkv, bt.shape[1]
    scale = 1.0 / d ** 0.5
    plan = ta.paged_split_plan(b, qn, h, hkv, d, m, SMS, kp.dtype, split_pages)
    ns, rpc, ss = plan["splits"], plan["rows_per_cta"], plan["split_pages"] * bs
    if ks is not None:
        kf, vf = ta._dequant_pages(kp, ks), ta._dequant_pages(vp, vs)
    else:
        kf, vf = kp.float(), vp.float()
    tp = torch.bfloat16 if vp.dtype == torch.bfloat16 else torch.float32
    nan = float("nan")
    ws_acc = torch.full((b, qn, h, ns, d), nan)
    ws_ml = torch.full((b, qn, h, ns, 2), nan)
    out = torch.full(q.shape, nan, dtype=q.dtype)
    stats = dict(plan, exited=0, masked_whole=0)
    for bi, hk, rt, s in itertools.product(range(b), range(hkv), range(plan["row_tiles"]),
                                           range(ns)):
        rows = torch.arange(rt * rpc, min((rt + 1) * rpc, qn * group))
        qi, hh = rows // group, hk * group + rows % group
        fr = qpos[bi, qi].long()
        start = s * ss
        end = min(start + ss, m * bs, max(int(fr.max()), 0) + 1)
        if start >= end:
            stats["exited"] += 1
            continue
        stats["masked_whole"] += int((fr < start).sum())
        pos = torch.arange(start, end)
        page = bt[bi, pos // bs].long()
        kk, vv = kf[page, pos % bs, hk], vf[page, pos % bs, hk]  # [S, D]
        x = (q[bi, qi, hh].float() @ kk.T) * scale
        x = torch.where(pos[None] > fr[:, None], torch.tensor(-1e30), x)
        mrun = torch.full((len(rows), 1), -1e30)
        l, acc = torch.zeros(len(rows), 1), torch.zeros(len(rows), d)
        for t0 in range(0, len(pos), TILE):
            xt = x[:, t0:t0 + TILE]
            mx = torch.maximum(mrun, xt.max(dim=1, keepdim=True).values)
            p, alpha = torch.exp(xt - mx), torch.exp(mrun - mx)
            l = l * alpha + p.sum(dim=1, keepdim=True)
            acc = acc * alpha + p.to(tp).float() @ vv[t0:t0 + TILE]
            mrun = mx
        if ns == 1:
            out[bi, qi, hh] = (acc / l).to(q.dtype)
        else:
            ws_acc[bi, qi, hh, s] = acc
            ws_ml[bi, qi, hh, s] = torch.cat([mrun, l], dim=1)
    if ns > 1:
        for bi, qi, hh in itertools.product(range(b), range(qn), range(h)):
            k = merge_count(int(qpos[bi, qi]), ss, ns)
            ml = ws_ml[bi, qi, hh, :k]
            w = torch.exp(ml[:, 0] - ml[:, 0].max())
            out[bi, qi, hh] = ((w @ ws_acc[bi, qi, hh, :k]) / (w @ ml[:, 1])).to(q.dtype)
    return out, stats


def _t(a):
    return torch.from_numpy(np.array(a))


# B 4, H 8 / Hkv 2, D 32, block size 4, a 12-page table, 2 pages (8 slots)
# a split: 6 splits a row
BS, M, SPLIT = 4, 12, 2
CASES = {
    # decode: a short row (splits 1-5 empty), frontiers 7 and 8 on either side
    # of the first boundary, and the padded row (ctx 1, a table of page 0)
    "decode_empty_splits_and_boundaries": (1, [4, 7, 8, 0], False),
    # extend, queries straddling a boundary (positions 6, 7, 8 / 14, 15, 16):
    # the split past a query's frontier is masked whole for its rows
    "extend_straddling_frontiers": (3, [8, 16, 40, 2], False),
    # 20 queries x group 4 = 80 rows: two row tiles, and the first tile's CTA
    # exits on splits the second tile's still reads
    "extend_row_tiles": (20, [23, 47, 30, 19], False),
    "int8_decode": (1, [4, 7, 8, 0], True),
    "int8_extend": (3, [8, 16, 40, 2], True),
}


def _case(name):
    qn, last, int8 = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    b, h, hkv, d, n = 4, 8, 2, 32, 4 * M + 1
    q = rng.randn(b, qn, h, d).astype(np.float32)
    kp = rng.randn(n, BS, hkv, d).astype(np.float32)
    vp = rng.randn(n, BS, hkv, d).astype(np.float32)
    bt = (rng.permutation(4 * M) + 1).reshape(b, M).astype(np.int32)
    last = np.asarray(last, np.int32)
    bt[last == 0] = 0  # the engine's padded decode row reads page 0 only
    qpos = np.maximum(last[:, None] - qn + 1 + np.arange(qn)[None], 0).astype(np.int32)
    return q, kp, vp, bt, qpos, int8


@pytest.fixture
def interpret():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_model_matches_reference_and_jax_kernel(interpret, name):
    q, kp, vp, bt, qpos, int8 = _case(name)
    jk, jv, jkw, tkw = jnp.asarray(kp), jnp.asarray(vp), {}, {}
    if int8:
        ks, vs = jobs.absmax_scale(jk, axis=-1), jobs.absmax_scale(jv, axis=-1)
        jk, jv = jobs.quantize_absmax(jk, ks[..., None]), jobs.quantize_absmax(jv, vs[..., None])
        jkw = dict(k_scales=ks, v_scales=vs)
        tkw = dict(ks=_t(ks), vs=_t(vs))
    tk, tv = _t(jk), _t(jv)
    got, stats = split_model(_t(q), tk, tv, _t(bt), _t(qpos), split_pages=SPLIT, **tkw)
    assert stats["splits"] == M // SPLIT and torch.isfinite(got).all()
    assert stats["exited"] > 0  # every case has a short row: its empty splits never run
    if "extend" in name:
        assert stats["masked_whole"] > 0  # written partials the merge must skip
    if name == "extend_row_tiles":
        assert stats["row_tiles"] == 2
    want = ta.paged_extend_reference(_t(q), tk, tv, _t(bt), _t(qpos),
                                     k_scales=tkw.get("ks"), v_scales=tkw.get("vs"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    ref = np.asarray(pk.paged_extend_reference(jnp.asarray(q), jk, jv, bt, qpos, **jkw))
    kern = np.asarray(pk._paged_extend_jit(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                                           jnp.asarray(qpos), **jkw))
    np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), kern, **F32_TOL)


def test_split_model_bf16_pages_rounds_p_like_the_reference():
    """bf16 pages: p rounded to bf16 before P.V, relative to each tile's
    running max (the reference rounds the normalised p): within a few bf16
    ulps of the output's scale."""
    q, kp, vp, bt, qpos, _ = _case("extend_straddling_frontiers")
    q, kp, vp = (_t(x).to(torch.bfloat16) for x in (q, kp, vp))
    got, _ = split_model(q, kp, vp, _t(bt), _t(qpos), split_pages=SPLIT)
    want = ta.paged_extend_reference(q, kp, vp, _t(bt), _t(qpos))
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 4 * 2.0 ** -8 * want.float().abs().max().item(), err


def test_merge_reading_every_split_would_read_garbage():
    """The merge rule is what keeps the output finite: merging every split
    of a row, the empty ones whose CTAs exited included, reads the NaN of
    an unwritten workspace (as `torch.empty` may hold)."""
    q, kp, vp, bt, qpos, _ = _case("decode_empty_splits_and_boundaries")
    q, kp, vp, bt, qpos = map(_t, (q, kp, vp, bt, qpos))
    ss = SPLIT * BS
    # frontier 4 reads split 0 only; 7 and 8, the last slot of split 0 and
    # the first of split 1, read one and two; the padded row (0) one
    assert [kernel_merge_count(int(qpos[i, 0]), ss, M // SPLIT) for i in range(4)] == [1, 1, 2, 1]
    got, _ = split_model(q, kp, vp, bt, qpos, split_pages=SPLIT)
    every, _ = split_model(q, kp, vp, bt, qpos, split_pages=SPLIT, merge_count=lambda f, s, n: n)
    assert torch.isfinite(got).all() and torch.isnan(every).any()


@pytest.mark.parametrize("b,m,split_pages,want", [
    # the serving shape (B 8, H 32/8, a 128-page table) on 132 SMs: 7 splits
    # of 19 pages, ~3 CTAs an SM
    (8, 128, None, dict(split_pages=19, splits=7, ctas=448)),
    (1, 128, None, dict(split_pages=4, splits=32, ctas=256)),   # one long row: 4 pages at least
    (8, 15, None, dict(split_pages=4, splits=4, ctas=256)),
    (8, 128, 16, dict(split_pages=16, splits=8, ctas=512)),     # an explicit split
    (8, 15, 15, dict(split_pages=15, splits=1, ctas=64)),       # one split: no workspace, no merge
])
def test_split_plan_from_shapes_alone(b, m, split_pages, want):
    """The plan reads shapes and the SM count only (no frontier from the
    device). bf16 pages (the mma path); the CUDA-core path asks for ~8 CTAs
    an SM: 16 splits of 8 pages at the serving shape."""
    cuda_core = ta.paged_split_plan(8, 1, 32, 8, 128, 128, SMS, torch.int8)
    assert (cuda_core["split_pages"], cuda_core["splits"]) == (8, 16)
    plan = ta.paged_split_plan(b, 1, 32, 8, 128, m, SMS, split_pages=split_pages)
    assert {k: plan[k] for k in want} == want
    assert plan["rows_per_cta"] == 4 and plan["row_tiles"] == 1
    assert plan["workspace_floats"] == (0 if want["splits"] == 1 else b * 32 * want["splits"] * 130)


@pytest.mark.parametrize("qn,d,kv,tiles,rows_per_cta", [
    (1, 128, torch.bfloat16, 1, 4), (4, 128, torch.bfloat16, 1, 16),     # the mma path: 16 rows
    (5, 128, torch.bfloat16, 2, 10), (40, 128, torch.bfloat16, 10, 16), (4, 64, torch.bfloat16, 1, 16),
    (40, 128, torch.int8, 3, 54), (40, 128, torch.float32, 3, 54),      # CUDA cores: 64 rows at D128
    (20, 256, torch.float32, 3, 27), (16, 96, torch.bfloat16, 1, 64),   # fewer at wider heads
])
def test_split_plan_row_tiles(qn, d, kv, tiles, rows_per_cta):
    """Q * group rows over as few CTAs as hold them, split evenly: 16 a CTA
    on the mma path (bf16 pages at head dim 64 or 128), else at most 64 at
    head dim 128 and proportionally fewer at wider heads."""
    assert ta.paged_uses_mma(kv, d) == (kv == torch.bfloat16 and d in (64, 128))
    plan = ta.paged_split_plan(2, qn, 32, 8, d, 128, SMS, kv, 128)
    assert (plan["row_tiles"], plan["rows_per_cta"]) == (tiles, rows_per_cta)
