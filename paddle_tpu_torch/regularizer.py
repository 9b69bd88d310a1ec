"""Weight-decay regularizers (a copy of paddle_tpu/regularizer.py: L1Decay,
L2Decay). Given as an optimizer's `weight_decay`: SGD and Momentum add
coeff * param (L2) or coeff * sign(param) (L1) to the gradient; Adam and
AdamW read only the coefficient."""
from __future__ import annotations


class WeightDecayRegularizer:
    pass


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay({self._coeff})"


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __repr__(self):
        return f"L1Decay({self._coeff})"


__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]
