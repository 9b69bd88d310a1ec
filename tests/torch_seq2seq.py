"""A Transformer seq2seq model written once against the paddle API, so the
same code runs on the JAX package and on the port (`pkg` is either): a
shared embedding (source, target and the output projection), scaled by
sqrt(d_model), plus sinusoidal positions, into `nn.Transformer`; the
label-smoothed loss of PaddleNLP's CrossEntropyCriterion; and beam-search
decoding through `BeamSearchDecoder`/`dynamic_decode`, with the decoder's
`gen_cache` caches as the cell states. It imports numpy only: the CPU
tests (tests/test_torch_transformer.py) and `chip_smoke.py`'s
transformer phases both read it.
"""
from __future__ import annotations

import math

import numpy as np

BOS, EOS = 0, 1


def sinusoid(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model] f32: sin on even channels, cos on odd (Vaswani et al. 2017 §3.5)."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    inv = np.exp(-math.log(10000.0) * np.arange(0, d_model, 2, dtype=np.float64) / d_model)
    table = np.zeros((max_len, d_model), np.float64)
    table[:, 0::2] = np.sin(pos * inv)
    table[:, 1::2] = np.cos(pos * inv)
    return table.astype(np.float32)


def make_model(pkg, vocab, d_model, nhead, num_encoder_layers, num_decoder_layers,
               dim_feedforward, dropout, normalize_before=False, max_len=256):
    """A `pkg.nn.Layer`: `embed` ([vocab, d_model], N(0, d_model^-1/2) as
    PaddleNLP draws it) and `transformer`."""

    class Seq2Seq(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.d_model = d_model
            self.embed = pkg.nn.Embedding(vocab, d_model, weight_attr=pkg.ParamAttr(
                initializer=pkg.nn.initializer.Normal(0.0, d_model ** -0.5)))
            self.transformer = pkg.nn.Transformer(
                d_model, nhead, num_encoder_layers, num_decoder_layers, dim_feedforward,
                dropout, normalize_before=normalize_before)
            self.table = sinusoid(max_len, d_model)  # numpy: it follows no .to()
            self.scale = math.sqrt(d_model)

        def embed_at(self, ids, start=0):
            pos = pkg.to_tensor(self.table[start:start + ids.shape[1]])
            return self.embed(ids) * self.scale + pos

        def logits(self, h):
            return pkg.matmul(h, self.embed.weight, transpose_y=True)

        def forward(self, src, tgt_in):
            mask = self.transformer.generate_square_subsequent_mask(tgt_in.shape[1])
            h = self.transformer(self.embed_at(src), self.embed_at(tgt_in), tgt_mask=mask)
            return self.logits(h)

    return Seq2Seq()


def loss_fn(pkg, logits, labels, vocab, epsilon=0.1):
    """mean softmax_with_cross_entropy against label_smooth(one_hot(labels))."""
    F = pkg.nn.functional
    soft = F.label_smooth(F.one_hot(labels, vocab), epsilon=epsilon)
    return pkg.mean(F.softmax_with_cross_entropy(logits, soft, soft_label=True))


def copy_task(rng, batch, seq, vocab):
    """A learnable task: the target is the source; teacher-forced input
    BOS + tgt[:-1]. Ids in [2, vocab)."""
    src = rng.randint(2, vocab, (batch, seq)).astype(np.int64)
    tgt_in = np.concatenate([np.full((batch, 1), BOS, np.int64), src[:, :-1]], axis=1)
    return src, tgt_in, src.copy()


def encode(model, src):
    return model.transformer.encoder(model.embed_at(src))


def decoder_cell(pkg, model, first_step_cache=False):
    """The cell BeamSearchDecoder drives: ids [B * beam] -> (logits [B *
    beam, V], caches), the caches those of TransformerDecoder.gen_cache: a
    (Cache, StaticCache) pair a layer. The position is the self-attention
    cache's length (dynamic_decode passes no step).

    With first_step_cache the states are (StaticCache, Cache) pairs whose
    Cache is None until the first step makes it (gen_cache of the tiled
    memory): the JAX package cannot tile an empty [B, 0, H, D] Cache
    (paddle's reshape reads a 0 in the target shape as "keep this
    dimension"), so its runs take this form."""
    layers = model.transformer.decoder.layers

    def cell(ids, caches, memory=None):
        if first_step_cache:
            caches = [(inc if inc is not None else layer.self_attn.gen_cache(memory), static)
                      for (static, inc), layer in zip(caches, layers)]
        t = caches[0][0].k.shape[1]
        x = model.embed_at(pkg.unsqueeze(ids, 1), start=t)
        h, caches = model.transformer.decoder(x, memory, cache=caches)
        if first_step_cache:
            caches = [(static, inc) for inc, static in caches]
        return model.logits(h[:, -1]), caches

    return cell


def beam_search(pkg, model, src, beam_size, max_step_num, first_step_cache=True):
    """predicted_ids [B, T, beam], scores [B, T, beam] and lengths [B, beam]."""
    memory = encode(model, src)
    caches = model.transformer.decoder.gen_cache(memory)
    if first_step_cache:
        caches = [(static, None) for _, static in caches]
    dec = pkg.nn.BeamSearchDecoder(decoder_cell(pkg, model, first_step_cache), start_token=BOS,
                                   end_token=EOS, beam_size=beam_size)
    tiled = pkg.nn.BeamSearchDecoder.tile_beam_merge_with_batch(memory, beam_size)
    out, _, lengths = pkg.nn.dynamic_decode(dec, inits=caches, max_step_num=max_step_num,
                                            return_length=True, memory=tiled)
    return out.predicted_ids, out.scores, lengths
