"""Seq2seq decoding: Decoder, BeamSearchDecoder and dynamic_decode
(counterpart of paddle_tpu/nn/decode.py).

The loop runs eagerly, a step at a time, as in the JAX package; it reads
`finished` from the device once a step to stop early. A beam step is
vectorized over batch and beams: log-softmax of the cell's logits, a
finished beam's row replaced by "only end_token, at no cost", top-k over
beam * vocab, then the parents' cell states, finished flags and lengths
gathered. The initial log-probs are 0 for beam 0 and -1e9 for the rest,
so the first step expands one beam. finalize replays the beam tree with
F.gather_tree. Beam choices are integer decisions: on equal inputs the
ids equal the JAX package's.
"""
from __future__ import annotations

import collections

import torch

from . import functional as F


def _map_structure(fn, obj):
    """fn over every tensor of a nest of lists, tuples, namedtuples and dicts."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        mapped = [_map_structure(fn, o) for o in obj]
        return type(obj)(*mapped) if hasattr(obj, "_fields") else type(obj)(mapped)
    if isinstance(obj, dict):
        return {k: _map_structure(fn, v) for k, v in obj.items()}
    return obj


def _map_structure2(fn, a, b):
    if isinstance(a, torch.Tensor) or not isinstance(a, (list, tuple, dict)):
        return fn(a, b)
    if isinstance(a, (list, tuple)):
        mapped = [_map_structure2(fn, x, y) for x, y in zip(a, b)]
        return type(a)(*mapped) if hasattr(a, "_fields") else type(a)(mapped)
    return {k: _map_structure2(fn, a[k], b[k]) for k in a}


def _first_tensor(obj):
    while not isinstance(obj, torch.Tensor):
        obj = next(iter(obj.values())) if isinstance(obj, dict) else obj[0]
    return obj


class Decoder:
    """The decoder contract dynamic_decode drives."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over `cell(inputs, states, **kwargs) -> (logits, states)`
    with merged [B * beam, ...] inputs and states; `embedding_fn` maps ids
    to the cell's inputs and `output_fn` the cell's outputs to logits."""

    OutputWrapper = collections.namedtuple("OutputWrapper",
                                           ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = collections.namedtuple("StateWrapper",
                                          ("cell_states", "log_probs", "finished", "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size, embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self.kinf = 1e9

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B * beam, ...], each row repeated beam_size times in place."""
        return x.unsqueeze(1).expand(x.shape[0], beam_size, *x.shape[1:]).reshape(
            x.shape[0] * beam_size, *x.shape[1:])

    def _split_batch_beams(self, x):
        return x.reshape(-1, self.beam_size, *x.shape[1:])

    def _merge_batch_beams(self, x):
        return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])

    def _expand_to_beam_size(self, x):
        return self.tile_beam_merge_with_batch(x, self.beam_size)

    def _gather(self, x, indices, batch_size):
        """x [B, beam, ...] at indices [B, beam] along the beam axis."""
        rows = torch.arange(x.shape[0], device=x.device).unsqueeze(1)
        return x[rows, indices.long()]

    def initialize(self, initial_cell_states):
        cell_states = _map_structure(self._expand_to_beam_size, initial_cell_states)
        sample = _first_tensor(cell_states)
        self.batch_size = sample.shape[0] // self.beam_size
        b, k, dev = self.batch_size, self.beam_size, sample.device
        log_probs = torch.full((b, k), -self.kinf, dtype=torch.float32, device=dev)
        log_probs[:, 0] = 0.0
        finished = torch.zeros(b, k, dtype=torch.bool, device=dev)
        lengths = torch.zeros(b, k, dtype=torch.int64, device=dev)
        init_ids = torch.full((b, k), self.start_token, dtype=torch.int64, device=dev)
        init_inputs = self.embedding_fn(init_ids) if self.embedding_fn else init_ids
        return self.StateWrapper(cell_states, log_probs, finished, lengths), init_inputs, finished

    def _mask_probs(self, probs, finished):
        """A finished beam's row: 0 at end_token, -kinf elsewhere."""
        noend = torch.full((probs.shape[-1],), -self.kinf, dtype=probs.dtype, device=probs.device)
        noend[self.end_token] = 0.0
        return torch.where(finished.unsqueeze(-1), noend, probs)

    def _beam_search_step(self, time, logits, next_cell_states, beam_state):
        b, k = self.batch_size, self.beam_size
        vocab = logits.shape[-1]
        step_lp = F.log_softmax(self._split_batch_beams(logits), axis=-1)  # [B, k, V]
        step_lp = self._mask_probs(step_lp, beam_state.finished)
        flat = (step_lp + beam_state.log_probs.unsqueeze(-1)).reshape(b, k * vocab)
        scores, topk_idx = torch.topk(flat, k, dim=1)
        beam_idx = topk_idx // vocab
        token_idx = topk_idx % vocab
        next_fin = beam_state.finished.gather(1, beam_idx)
        next_len = beam_state.lengths.gather(1, beam_idx) + (~next_fin).long()
        next_fin = next_fin | (token_idx == self.end_token)
        next_cell_states = _map_structure(
            lambda x: self._merge_batch_beams(self._gather(self._split_batch_beams(x), beam_idx,
                                                           b)),
            next_cell_states)
        out = self.OutputWrapper(scores, token_idx, beam_idx)
        return out, self.StateWrapper(next_cell_states, scores, next_fin, next_len)

    def step(self, time, inputs, states, **kwargs):
        if isinstance(inputs, torch.Tensor):
            merged = (self._merge_batch_beams(inputs) if inputs.dim() > 1 and tuple(
                inputs.shape[:2]) == (self.batch_size, self.beam_size) else inputs)
        else:
            merged = _map_structure(self._merge_batch_beams, inputs)
        cell_outputs, next_cell_states = self.cell(merged, states.cell_states, **kwargs)
        if self.output_fn is not None:
            cell_outputs = self.output_fn(cell_outputs)
        out, state = self._beam_search_step(time, cell_outputs, next_cell_states, states)
        next_inputs = self.embedding_fn(out.predicted_ids) if self.embedding_fn else \
            out.predicted_ids
        return out, state, next_inputs, state.finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """The beam paths replayed: predicted_ids [T, B, beam] by gather_tree."""
        predicted_ids = F.gather_tree(outputs.predicted_ids, outputs.parent_ids)
        return self.OutputWrapper(outputs.scores, predicted_ids, outputs.parent_ids), final_states

    @property
    def tracks_own_finished(self):
        return True


def _stack_structures(items):
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items, dim=0)
    if isinstance(first, (list, tuple)):
        cols = [_stack_structures([it[i] for it in items]) for i in range(len(first))]
        return type(first)(*cols) if hasattr(first, "_fields") else type(first)(cols)
    if isinstance(first, dict):
        return {k: _stack_structures([it[k] for it in items]) for k in first}
    return first


def _where_finished(finished, old, new):
    """`old` where finished, else `new`: finished [B, beam] against a beam
    tensor [B, beam, ...], or flattened against a cell state [B * beam, ...]."""
    if not isinstance(old, torch.Tensor):
        return new
    if tuple(old.shape[:finished.dim()]) == tuple(finished.shape):
        fin, lead = finished, finished.dim()
    else:
        fin, lead = finished.reshape(-1), 1
    return torch.where(fin.reshape(*fin.shape, *([1] * (old.dim() - lead))), old, new)


def dynamic_decode(decoder, inits=None, max_step_num=None, output_time_major=False,
                   impute_finished=False, is_test=False, return_length=False, **kwargs):
    """Run `decoder` from decoder.initialize(inits) until every sequence
    has finished or max_step_num steps. Returns (outputs, final_states),
    plus the lengths with return_length; outputs are [B, T, ...] unless
    output_time_major. impute_finished keeps a finished sequence's states
    as they were. `kwargs` go to every step."""
    states, inputs, finished = decoder.initialize(inits)
    step_outputs, time = [], 0
    while max_step_num is None or time < max_step_num:
        outputs, next_states, next_inputs, next_finished = decoder.step(time, inputs, states,
                                                                        **kwargs)
        if not decoder.tracks_own_finished:
            next_finished = next_finished | finished
        if impute_finished:
            next_states = _map_structure2(lambda new, old: _where_finished(finished, old, new),
                                          next_states, states)
        step_outputs.append(outputs)
        states, inputs, finished = next_states, next_inputs, next_finished
        time += 1
        if bool(finished.all()):
            break
    stacked = _stack_structures(step_outputs)
    lengths = getattr(states, "lengths", None)
    final_outputs, final_states = decoder.finalize(stacked, states, lengths)
    if not output_time_major:
        final_outputs = _map_structure(lambda t: t.transpose(0, 1), final_outputs)
    if return_length:
        return final_outputs, final_states, lengths
    return final_outputs, final_states
