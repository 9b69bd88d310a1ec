"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu (serving, Llama
training, ERNIE MLM pretraining and ResNet ImageNet training slices, with
float16 AMP under a GradScaler, O2, recompute, param groups and
checkpoints in the JAX package's format; PP-OCR det+rec and PP-YOLOE;
the paddle Tensor and op surface, and ERNIE sequence classification;
io, vision transforms and datasets, MobileNetV1-V3 and hapi).

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

    # a replica fleet with QoS, hot swaps and prefill/decode tiers; telemetry
    fleet = paddle.inference.ReplicaFleet([engine, paddle.inference.InferenceEngine(model)],
                                          qos=paddle.inference.QoSPolicy())
    stats = paddle.inference.fleet_replay(fleet, requests)
    text = paddle.telemetry.to_prometheus()

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

    # the op surface: Tensor is torch.Tensor, with paddle's methods attached
    x = paddle.to_tensor([[1.0, 2.0]], stop_gradient=False)
    y = paddle.concat([x, x], axis=0).transpose([1, 0]).astype("float32")
    (g,) = paddle.grad(paddle.sum(y * y), x)
    pred = paddle.argmax(model(ids, attention_mask=(ids != 0).astype("int64")), axis=-1)

The ops are plain torch ops (ops/{creation,math,manipulation,logic,search,
linalg,einsum,inplace}.py); ops/_patch.py says which Tensor methods are
paddle's and which stay torch's.

    # nn: Transformer training and beam-search decoding
    model = paddle.nn.Transformer(d_model=512, nhead=8, dim_feedforward=2048)
    out = model(src_emb, tgt_emb, tgt_mask=model.generate_square_subsequent_mask(T))
    decoder = paddle.nn.BeamSearchDecoder(cell, start_token=0, end_token=1, beam_size=4)
    ids, _ = paddle.nn.dynamic_decode(decoder, inits=caches, max_step_num=114, memory=mem)

    # a guarded, profiled training loop: a NaN step rolls back to the last
    # snapshot; the card's kernels land in the exported chrome trace
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    guardian = paddle.TrainingGuardian(opt, policy="rollback", lkg_interval=100)
    with paddle.profiler.Profiler(scheduler=(2, 5), on_trace_ready=
                                  paddle.profiler.export_chrome_tracing("./trace")) as prof:
        for ids in batches:
            loss, _ = model(ids, labels=ids)
            loss.backward()
            guardian.step(loss)       # 'ok' | 'skipped' | 'rolled_back'
            opt.clear_grad()
            prof.step()

The nn remainder (activations, losses, norms, pools, the functional
common set, Layer's paddle methods, initializers, nn.utils, decode) is
plain torch too; attention reaches the flash kernels where a call has no
mask.

    # input and PaddleClas-style training through hapi: host transforms in
    # spawned workers, batches to the card through a ring of pinned buffers
    T = paddle.vision.transforms
    train = MyDataset(transform=T.Compose([T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
                                           T.Normalize(mean, std, data_format="HWC"),
                                           T.Transpose()]))
    loader = paddle.io.DataLoader(train, batch_size=64, shuffle=True, num_workers=7,
                                  persistent_workers=True)
    model = paddle.Model(paddle.vision.models.mobilenet_v3_large())
    model.prepare(opt, paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy(topk=(1, 5)),
                  amp_configs="O1")
    model.fit(loader, epochs=2)
    macs = paddle.flops(model.network, [1, 3, 224, 224])

    # sharded, resumable, device-prefetched input with reader-lag telemetry
    loader = paddle.io.streaming.StreamingLoader(dataset, 64, seed=7, donate=True)
    state = loader.state_dict()   # resume mid-epoch: loader.load_state_dict(state)
"""
import torch

from . import (amp, core, device, distributed, framework, incubate, inference, jit, models, nn,
               ops, optimizer, quantization, regularizer, static, telemetry, utils, vision)
from .core import autograd_engine as _autograd_engine
from .framework.compat import (check_shape, disable_signal_handler, get_cuda_rng_state,
                               set_cuda_rng_state)
from .framework.device import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Place, TPUPlace,
                               device_count, get_device, set_device)
from .framework.dtype import convert_dtype, get_default_dtype, set_default_dtype
from .framework.flags import get_flags, set_flags
from .framework.guardian import (DesyncDetector, FlightRecorder, GuardianAnomaly,
                                 TrainingGuardian)
from .framework.io import load, save
from .framework.random import get_rng_state, seed, set_rng_state
from .jit import to_static
from .nn.functional import pdist
from .nn.initializer import ParamAttr

_autograd_engine.install()

# ---- the paddle Tensor and op surface (ops/*.py; methods in ops/_patch.py) ----
from .core.tensor import Tensor, set_printoptions  # noqa: E402
from .ops.creation import *  # noqa: F401,F403,E402
from .ops.math import *  # noqa: F401,F403,E402
from .ops.manipulation import *  # noqa: F401,F403,E402
from .ops.logic import *  # noqa: F401,F403,E402
from .ops.search import *  # noqa: F401,F403,E402
from .ops.linalg import (bmm, cdist, cholesky, cholesky_solve, corrcoef, cov, dist,  # noqa: E402
                         inverse, matmul, mm, mv, norm)
from .ops.einsum import einsum  # noqa: E402
from .ops.inplace import *  # noqa: F401,F403,E402
from . import autograd, linalg, metric, profiler  # noqa: E402
from . import callbacks, hapi, io  # noqa: E402
from .hapi import Model, summary  # noqa: E402
from .autograd import (PyLayer, enable_grad, grad, is_grad_enabled, no_grad,  # noqa: E402
                       set_grad_enabled)

bool = bool_ = bool8 = torch.bool  # noqa: A001  (paddle.bool)
(uint8, int8, int16, int32, int64, float16, bfloat16, float32, float64, complex64,
 complex128) = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64, torch.float16,
                torch.bfloat16, torch.float32, torch.float64, torch.complex64, torch.complex128)
float8_e4m3fn, float8_e5m2 = torch.float8_e4m3fn, torch.float8_e5m2
dtype = torch.dtype  # the type of paddle.float32 and the rest


def finfo(dtype):  # noqa: F811
    """torch.finfo of a dtype or its name (bits, eps, max, min, tiny, ...)."""
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):  # noqa: F811
    return torch.iinfo(convert_dtype(dtype))


def in_dynamic_mode():
    return True


def in_dynamic_or_pir_mode():
    return True


def disable_static(place=None):
    """Dygraph is the only mode; kept for paddle's callers."""


def enable_static():
    """A no-op, as in the JAX package: static programs are captured under
    paddle.static.program_guard, in dygraph."""


def is_compiled_with_cuda():
    return torch.cuda.is_available()


def is_compiled_with_tpu():
    """The port is not built for a TPU."""
    return False


def is_compiled_with_xpu():
    return False


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_cinn():
    return False


def is_compiled_with_distribute():
    return torch.distributed.is_available()


def get_cudnn_version():
    return torch.backends.cudnn.version() if torch.cuda.is_available() else None


def device_guard(*args, **kwargs):
    """A no-op context (paddle's static-graph device placement)."""
    import contextlib

    return contextlib.nullcontext()


class LazyGuard:
    """paddle.LazyGuard: parameters are made when their layer is built,
    as in the JAX package; the guard changes nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def batch(reader, batch_size, drop_last=False):
    """paddle.batch: a reader of lists of `batch_size` items of `reader`'s
    (the last shorter one kept unless drop_last)."""

    def batched():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batched


def flops(net, input_size, custom_ops=None, print_detail=False):
    """paddle.flops (python/paddle/hapi/dynamic_flops.py; the JAX package's
    paddle_tpu/__init__.py:260-305): the MACs of the Conv2D and Linear
    layers over one forward of zeros of `input_size`, an integer."""
    from .framework.device import current_device
    from .nn.layers.common import Linear as _Linear
    from .nn.layers.conv import Conv2D as _Conv2D

    total = {"flops": 0}
    hooks = []

    def conv_hook(lyr, ins, outs):
        w = lyr.weight
        out_elems = 1
        for d in outs.shape[2:]:
            out_elems *= int(d)
        k = 1
        for d in w.shape[1:]:
            k *= int(d)
        total["flops"] += int(outs.shape[0]) * int(w.shape[0]) * k * out_elems

    def linear_hook(lyr, ins, outs):
        n = 1
        for d in outs.shape[:-1]:
            n *= int(d)
        total["flops"] += n * int(lyr.weight.shape[0]) * int(lyr.weight.shape[1])

    for _, sub in net.named_sublayers(include_self=False):
        if isinstance(sub, _Conv2D):
            hooks.append(sub.register_forward_post_hook(conv_hook))
        elif isinstance(sub, _Linear):
            hooks.append(sub.register_forward_post_hook(linear_hook))
    was_training = net.training
    net.eval()
    dev = next((p.device for p in net.parameters()), None) or current_device()
    try:
        with torch.no_grad():
            net(torch.zeros(tuple(input_size), dtype=torch.float32, device=dev))
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            net.train()
    if print_detail:
        print(f"Total FLOPs (MACs): {total['flops']:,}")
    return total["flops"]
