"""Port parity of nn.Transformer training and beam-search decoding
(paddle_tpu_torch/nn/layers/transformer.py, nn/decode.py): a tiny
Transformer seq2seq (tests/torch_seq2seq.py, one code for both packages)
from the JAX model's weights, its label-smoothed loss and gradients, an
Adam step, incremental decoding against the full decoder, and greedy
(beam 1) and beam-4 ids equal to the JAX package's; and the cases of
tests/test_decode.py against both packages."""
import functools

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread: see the module)

import paddle_tpu as paddle
import paddle_tpu_torch as ptt

import torch_seq2seq as s2s

V, D, H, FFN = 48, 32, 4, 64
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _cpu():
    ptt.set_device("cpu")


def _np(t):
    return np.asarray(t._value) if isinstance(t, paddle.Tensor) else t.detach().numpy()


@functools.lru_cache(maxsize=None)
def _models(normalize_before):
    """The JAX model and the port's, carrying its weights; eval mode."""
    ptt.set_device("cpu")
    paddle.seed(0)
    cfg = dict(vocab=V, d_model=D, nhead=H, num_encoder_layers=2, num_decoder_layers=2,
               dim_feedforward=FFN, dropout=0.0, normalize_before=normalize_before)
    jm = s2s.make_model(paddle, **cfg)
    tm = s2s.make_model(ptt, **cfg)
    assert [n for n, _ in tm.named_parameters()] == [n for n, _ in jm.named_parameters()]
    assert tm.set_state_dict({k: _np(v) for k, v in jm.state_dict().items()}) == ([], [])
    jm.eval()
    tm.eval()
    return jm, tm


@pytest.fixture(params=[False, True], ids=["post_ln", "pre_ln"])
def models(request):
    return _models(request.param)


def _batch(pkg, seed=0):
    src, tgt_in, labels = s2s.copy_task(np.random.RandomState(seed), 3, 7, V)
    return [pkg.to_tensor(a) for a in (src, tgt_in, labels)]


def test_loss_and_grads_match_jax(models):
    """The forward with the causal tgt_mask, the label-smoothed loss and
    every parameter's gradient, then one Adam step's parameters (the key
    biases, whose gradient is rounding noise, within 2 lr)."""
    res = {}
    for pkg, m in zip((paddle, ptt), models):
        src, tgt_in, labels = _batch(pkg)
        logits = m(src, tgt_in)
        loss = s2s.loss_fn(pkg, logits, labels, V)
        loss.backward()
        grads = {n: _np(p.grad) for n, p in m.named_parameters()}
        opt = pkg.optimizer.Adam(1e-3, beta1=0.9, beta2=0.98, epsilon=1e-9,
                                 parameters=m.parameters())
        opt.step()
        opt.clear_grad()
        res[pkg] = (_np(logits), float(_np(loss)), grads,
                    {n: _np(p) for n, p in m.named_parameters()})
    (tl, tloss, tg, tp), (jl, jloss, jg, jp) = res[ptt], res[paddle]
    np.testing.assert_allclose(tl, jl, **TOL)
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    for n, w in jg.items():
        np.testing.assert_allclose(tg[n], w, rtol=1e-3, atol=1e-5, err_msg=n)
    for n, w in jp.items():
        if n.endswith("k_proj.bias"):
            # C-trap10: the key bias's gradient is 0 but for rounding, and
            # Adam turns that noise into steps of up to lr either way
            assert np.abs(tp[n] - w).max() <= 2 * 1e-3, n
            continue
        np.testing.assert_allclose(tp[n], w, rtol=1e-5, atol=1e-6, err_msg=n)


def test_incremental_decoding_matches_the_full_decoder(models):
    """Step-by-step decoding through gen_cache's (Cache, StaticCache) pairs
    gives the full causal decoder's last-position output at every step, in
    both packages, and the two agree."""
    outs = {}
    for pkg, m in zip((paddle, ptt), models):
        with pkg.no_grad():
            src, tgt_in, _ = _batch(pkg, 1)
            memory = s2s.encode(m, src)
            caches = m.transformer.decoder.gen_cache(memory)
            steps = []
            for t in range(tgt_in.shape[1]):
                x = m.embed_at(tgt_in[:, t:t + 1], start=t)
                h, caches = m.transformer.decoder(x, memory, cache=caches)
                steps.append(_np(h)[:, 0])
            mask = m.transformer.generate_square_subsequent_mask(tgt_in.shape[1])
            full = _np(m.transformer.decoder(m.embed_at(tgt_in), memory, tgt_mask=mask))
        np.testing.assert_allclose(np.stack(steps, 1), full, rtol=1e-4, atol=1e-5)
        assert tuple(caches[0][0].k.shape) == (3, 7, H, D // H)
        outs[pkg] = full
    np.testing.assert_allclose(outs[ptt], outs[paddle], **TOL)


@pytest.mark.parametrize("beam", [1, 4])
def test_beam_search_ids_match_jax(beam):
    """Beam search over the decoder with caches: ids and lengths exactly the
    JAX package's, scores to f32 rounding and sorted across beams; the
    port gives the same taking gen_cache's caches as the initial states."""
    models = _models(False)  # post-LN; both forms are held by the tests above
    res = {}
    for pkg, m in zip((paddle, ptt), models):
        with pkg.no_grad():
            src, _, _ = _batch(pkg, 2)
            ids, scores, lengths = s2s.beam_search(pkg, m, src, beam, 7)
        res[pkg] = (_np(ids), _np(scores), _np(lengths))
    (ti, ts, tl), (ji, js, jl) = res[ptt], res[paddle]
    with torch.no_grad():  # the port also takes gen_cache's empty Cache as it is
        direct = s2s.beam_search(ptt, models[1], _batch(ptt, 2)[0], beam, 7,
                                 first_step_cache=False)
    assert all(np.array_equal(_np(d), r) for d, r in zip(direct, res[ptt]))
    assert ti.shape == ji.shape and ti.shape[0] == 3 and ti.shape[2] == beam
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-4)
    assert (np.diff(ts, axis=2) <= 1e-5).all()


# ---- tests/test_decode.py's cases, against both packages -------------------

def _build(pkg, beam_size, vocab=7, hidden=8, batch=3):
    paddle.seed(5)
    jcell, jemb, jout = (paddle.nn.GRUCell(hidden, hidden), paddle.nn.Embedding(vocab, hidden),
                         paddle.nn.Linear(hidden, vocab))
    if pkg is paddle:
        cell, emb, out = jcell, jemb, jout
    else:
        cell, emb, out = ptt.nn.GRUCell(hidden, hidden), ptt.nn.Embedding(vocab, hidden), \
            ptt.nn.Linear(hidden, vocab)
        for t, j in ((cell, jcell), (emb, jemb), (out, jout)):
            t.set_state_dict({k: _np(v) for k, v in j.state_dict().items()})
    dec = pkg.nn.BeamSearchDecoder(cell, start_token=0, end_token=1, beam_size=beam_size,
                                   embedding_fn=emb, output_fn=out)
    enc_final = pkg.to_tensor(np.random.RandomState(0).randn(batch, hidden).astype("float32"))
    return dec, enc_final, (cell, emb, out)


@pytest.mark.parametrize("case", ["shapes", "beam1_greedy", "time_major", "impute"])
def test_decode_cases_match_jax(case):
    """Shapes and sorted scores (beam 4, 6 steps), beam 1 equal to a greedy
    loop over the same cell, time-major outputs with lengths, and
    impute_finished: ids, lengths and scores equal to the JAX package's."""
    res = {}
    for pkg in (paddle, ptt):
        beam = {"shapes": 4, "beam1_greedy": 1, "time_major": 2, "impute": 4}[case]
        dec, enc_final, (cell, emb, out) = _build(pkg, beam)
        kw = dict(max_step_num={"shapes": 6, "beam1_greedy": 5, "time_major": 4,
                                "impute": 5}[case])
        if case == "time_major":
            kw.update(output_time_major=True, return_length=True)
        if case == "impute":
            kw.update(impute_finished=True)
        got = pkg.nn.dynamic_decode(dec, inits=enc_final, **kw)
        outputs, states = got[0], got[1]
        ids, scores = _np(outputs.predicted_ids), _np(outputs.scores)
        res[pkg] = [ids, scores, _np(states.finished)] + ([_np(got[2])] if len(got) > 2 else [])
        if case == "shapes":
            assert ids.shape[0] == 3 and ids.shape[2] == 4 and scores.shape == ids.shape
            assert (np.diff(scores, axis=2) <= 1e-5).all() and np.isfinite(scores[:, 0]).all()
            assert ids.min() >= 0 and ids.max() < 7
        if case == "beam1_greedy":
            state, cur = enc_final, pkg.to_tensor(np.zeros((3,), np.int64))
            want, finished = [], np.zeros((3,), bool)
            for _ in range(5):
                o, state = cell(emb(cur), state)
                nxt = np.where(finished, 1, _np(out(o)).argmax(-1))
                want.append(nxt)
                finished |= nxt == 1
                cur = pkg.to_tensor(nxt.astype(np.int64))
            np.testing.assert_array_equal(ids[:, :5, 0], np.stack(want, 1))
        if case == "time_major":
            assert ids.shape[1] == 3 and res[pkg][3].shape == (3, 2)
        if case == "impute":
            assert res[pkg][2].shape == (3, 4)
    for i, (g, w) in enumerate(zip(res[ptt], res[paddle])):
        if i == 1:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w)


def test_tile_beam_merge_with_batch():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = ptt.nn.BeamSearchDecoder.tile_beam_merge_with_batch(torch.from_numpy(x), 4)
    want = paddle.nn.BeamSearchDecoder.tile_beam_merge_with_batch(paddle.to_tensor(x), 4)
    np.testing.assert_array_equal(got.numpy(), _np(want))
