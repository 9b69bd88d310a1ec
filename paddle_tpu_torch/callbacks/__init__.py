"""paddle.callbacks (counterpart of paddle_tpu/callbacks/; reference:
python/paddle/callbacks.py re-exports the hapi callbacks)."""
from ..hapi.callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRScheduler,
    ModelCheckpoint,
    ProgBarLogger,
    ReduceLROnPlateau,
    VisualDL,
    WandbCallback,
)

__all__ = [
    "Callback",
    "ProgBarLogger",
    "ModelCheckpoint",
    "LRScheduler",
    "EarlyStopping",
    "ReduceLROnPlateau",
    "VisualDL",
    "WandbCallback",
]
