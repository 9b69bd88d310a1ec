"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu (serving, Llama
training, ERNIE MLM pretraining and ResNet ImageNet training slices, with
float16 AMP under a GradScaler, O2, recompute, param groups and
checkpoints in the JAX package's format; PP-OCR det+rec and PP-YOLOE).

A package of its own beside the JAX package (which stays the reference);
it imports torch and nothing of jax or paddle_tpu. Entry points run on
cuda:0 unless `set_device("cpu")` asks for the CPU. The kernels (flash
forward and backward, paged attention, fused AdamW, RMSNorm) are
hand-written CUDA for sm_90a (ops/kernels/*.cu), built with nvcc at first
CUDA use.

    import paddle_tpu_torch as paddle
    paddle.seed(0)
    model = paddle.models.llama.LlamaForCausalLM(**config)

    # serving
    engine = paddle.inference.InferenceEngine(model.eval(), max_seq_len=2048)
    ids = engine.generate(prompts, max_new_tokens=32)

    # training
    paddle.set_flags({"FLAGS_fused_optimizer": True})
    opt = paddle.optimizer.AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                                 moment2_dtype="bfloat16")
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        loss, _ = model(ids, labels=labels)
    loss.backward()
    opt.step()
    opt.clear_grad()

    # ERNIE MLM pretraining: bench.py's build_train_step runs as written,
    # its step under paddle.jit.to_static (which runs it eagerly)
    model = paddle.models.ErnieForMaskedLM(paddle.models.ErnieModel(hidden_dropout_prob=0.0))
    loss, _ = model(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))

    # ResNet-50 ImageNet training: bench.py's build_resnet_step runs as written
    model = paddle.vision.models.resnet50(num_classes=1000)
    opt = paddle.optimizer.Momentum(0.1, parameters=model.parameters(), weight_decay=1e-4)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = paddle.nn.functional.cross_entropy(model(images), labels)

The convs, batch norms, pools and the Momentum update are plain torch ops
(cuDNN convs on the card), as the JAX package leaves them to XLA.

    # float16 with loss scaling; checkpoint and resume
    scaler = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 15)
    with paddle.amp.auto_cast(level="O1", dtype="float16"):
        loss, _ = model(ids, labels=labels)
    scaler.scale(loss).backward()
    scaler.step(opt)
    paddle.save({"model": model.state_dict(), "opt": opt.state_dict()}, path)

    # PP-OCR det+rec: bench.py's _build_ppocr runs as written
    sys_ = paddle.models.OCRSystem()          # DBNet + CRNN (BiLSTM, CTC)
    results = sys_(page)                      # per image: (box, label ids)

    # PP-YOLOE: forward, decode + class-aware nms, dense loss
    det = paddle.models.PPYOLOE(num_classes=80)
    rows = det.infer(images)
    loss = paddle.models.ppyoloe_loss(det(images), targets, 80)

Transposed convs, interpolate, the RNN cells, ctc_loss and nms are plain
torch ops too (the JAX package leaves them to XLA); the box and label
postprocess runs on the host, as there.
"""
from . import (amp, distributed, framework, incubate, inference, jit, models, nn, ops, optimizer,
               quantization, regularizer, utils, vision)
from .framework.device import get_device, set_device
from .framework.dtype import get_default_dtype, set_default_dtype
from .framework.flags import get_flags, set_flags
from .framework.io import load, save
from .framework.random import seed
from .ops.creation import to_tensor
from .ops.manipulation import flatten

__all__ = ["amp", "distributed", "framework", "incubate", "inference", "jit", "models", "nn", "ops", "optimizer",
           "quantization", "regularizer", "utils", "vision", "get_device", "set_device",
           "get_default_dtype", "set_default_dtype", "get_flags", "set_flags", "seed", "to_tensor",
           "flatten", "save", "load"]
