"""Port parity: the int8 quantization grid and the paged KV pool
(paddle_tpu_torch.quantization / inference.kv_cache) against the JAX
package. Integer results and allocator decisions must match exactly."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import jax.numpy as jnp

from paddle_tpu.inference import kv_cache as jkv
from paddle_tpu.quantization import observers as jobs
from paddle_tpu_torch.inference import kv_cache as tkv
from paddle_tpu_torch.quantization import observers as tobs


def _t(a):
    return torch.from_numpy(np.array(a))


def test_quantize_grid_is_exact():
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 8, 2, 16) * rng.choice([1e-3, 1.0, 40.0], (6, 1, 1, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # all-zero slot: the scale floor
    # values that land on half-integers of the grid: round half to even
    x[1, 0, 0, :6] = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -2.5], np.float32)
    js = jobs.absmax_scale(jnp.asarray(x), axis=-1)
    ts = tobs.absmax_scale(_t(x), dim=-1)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq = jobs.quantize_absmax(jnp.asarray(x), js[..., None])
    tq = tobs.quantize_absmax(_t(x), ts[..., None])
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tobs.dequantize_absmax(tq, ts[..., None]).numpy(),
                                  np.asarray(jobs.dequantize_absmax(jq, js[..., None])))


def _pool_state(pool):
    return (list(pool._free), dict(pool._refs), list(pool._retained.items()),
            dict(pool._prefix), dict(pool._page_key), pool.cow_copies)


def test_block_pool_decisions_match_seeded_sequence():
    """A seeded alloc/share/free/retain/evict/register/acquire/make_private
    sequence gives identical returns, errors and pool state, and make_private
    copies the same page contents."""
    kw = dict(num_blocks=10, block_size=4, num_layers=2, num_kv_heads=2, head_dim=4)
    jp = jkv.BlockPool(**kw)
    tp = tkv.BlockPool(**kw, device="cpu")
    content = np.random.RandomState(1).randn(2, 10, 4, 2, 4).astype(np.float32)
    jp.k_pages = [jnp.asarray(c) for c in content]
    for i, c in enumerate(content):
        tp.k_pages[i].copy_(_t(c))
    rng = np.random.RandomState(1234)
    held, key_n = [], 0
    stats = {"cow": 0, "hits": 0, "evicted": 0}
    for step in range(300):
        op = rng.choice(["alloc", "free", "free_keep", "share", "register", "acquire", "cow"])
        args = ()
        if op == "alloc":
            args = (int(rng.randint(1, 4)),)
        elif op in ("free", "free_keep", "share", "cow") and held:
            args = (held[rng.randint(len(held))],)
        elif op == "register" and held:
            args = (bytes([key_n % 7]), held[rng.randint(len(held))])
        elif op == "acquire":
            args = ([bytes([i]) for i in range(rng.randint(1, 4))],)
        else:
            continue
        results = []
        retained_before = jp.retained()
        for pool in (jp, tp):
            try:
                if op == "alloc":
                    out = pool.alloc(*args)
                elif op == "free":
                    out = pool.free([args[0]], retain=False)
                elif op == "free_keep":
                    out = pool.free([args[0]], retain=True)
                elif op == "share":
                    out = pool.share([args[0]])
                elif op == "register":
                    out = pool.register_prefix(*args)
                elif op == "acquire":
                    out = pool.acquire_prefix(*args)
                else:
                    out = pool.make_private(args[0])
                results.append(("ok", out))
            except (ValueError, jkv.PoolExhausted, tkv.PoolExhausted) as e:
                results.append(("err", type(e).__name__))
        assert results[0] == results[1], (step, op, args, results)
        assert _pool_state(jp) == _pool_state(tp), (step, op, args)
        status, out = results[0]
        if status == "ok" and op in ("alloc", "acquire"):
            held.extend(out)
        elif status == "ok" and op == "cow":
            held.append(out)
        elif status == "ok" and op == "share":
            held.append(args[0])
        elif status == "ok" and op.startswith("free"):
            held.remove(args[0])
        key_n += op == "register"
        stats["cow"] += status == "ok" and op == "cow"
        stats["hits"] += status == "ok" and op == "acquire" and bool(out)
        stats["evicted"] += status == "ok" and op == "alloc" and retained_before > jp.retained()
    assert stats["cow"] > 0 and stats["evicted"] > 0 and stats["hits"] > 0
    for layer in range(2):
        np.testing.assert_array_equal(tp.k_pages[layer].numpy(), np.asarray(jp.k_pages[layer]))
    assert tp.invalidate_prefix() == jp.invalidate_prefix()
    assert _pool_state(jp) == _pool_state(tp)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_view_write_scatter_matches(kv_dtype):
    """write() lands every position in page table[p // bs], slot p % bs;
    write_mask=False positions go to the trash page. Compared off page 0
    (the trash page receives colliding scribbles in either order)."""
    kw = dict(num_blocks=8, block_size=4, num_layers=1, num_kv_heads=2, head_dim=8,
              kv_dtype=kv_dtype)
    jp, tp = jkv.BlockPool(**kw), tkv.BlockPool(**kw, device="cpu")
    rng = np.random.RandomState(5)
    bt = np.asarray([[3, 5, 0], [6, 1, 2]], np.int32)
    pos = np.asarray([[2, 3, 4, 5, 6], [0, 1, 2, 3, 9]], np.int32)
    mask = np.asarray([[True] * 5, [True, True, False, True, True]])
    k = rng.randn(2, 5, 2, 8).astype(np.float32)
    v = rng.randn(2, 5, 2, 8).astype(np.float32)
    jv = jp.view(bt, pos[:, -1] + 1, write_mask=jnp.asarray(mask))
    jv.write(0, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    tv = tp.view(_t(bt), _t(pos[:, -1] + 1), write_mask=_t(mask))
    tv.write(0, _t(k), _t(v), _t(pos))
    planes = [(tv.k_pages, jv.k_pages), (tv.v_pages, jv.v_pages)]
    if kv_dtype:
        planes += [(tv.k_scales, jv.k_scales), (tv.v_scales, jv.v_scales)]
    for got, want in planes:
        np.testing.assert_array_equal(got[0].numpy()[1:], np.asarray(want[0])[1:])
    # the masked position (row 1, position 2: page 6, slot 2) wrote nothing
    assert not tp.k_pages[0][6, 2].any()
    # the view writes the pool's own tensors in place
    assert tv.k_pages[0] is tp.k_pages[0]


def test_chain_keys_and_padded_table():
    toks = list(range(11))
    assert tkv.prefix_chain_keys(toks, 4) == jkv.prefix_chain_keys(toks, 4)
    assert tkv.chain_extend(b"x", [1, 2]) == jkv.chain_extend(b"x", [1, 2])
    pool = tkv.BlockPool(6, 8, 1, 2, 4, device="cpu")
    assert pool.padded_table([4, 2], 4) == [4, 2, tkv.TRASH_PAGE, tkv.TRASH_PAGE]
    assert pool.blocks_for_tokens(9) == 2 and pool.available() == 5
    with pytest.raises(tkv.PoolExhausted):
        pool.alloc(6)
