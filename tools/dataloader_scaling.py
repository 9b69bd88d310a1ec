#!/usr/bin/env python3
"""How the port's DataLoader delivery rate scales with its worker count, and
where a batch's time goes, on the card's host (run it where `chip_smoke.py`
runs: one GPU, its cores).

    python3 tools/dataloader_scaling.py [--workers 1,4,7] [--images 704] \
        [--out chiprun_out/dataloader_scaling.json]

Builds `chip_smoke.py`'s mobilenetv3_fit input: seeded 256x256x3 uint8
images (ColourClassImages), PaddleClas's train transforms (RandomResizedCrop
224, RandomHorizontalFlip, Normalize, Transpose), batches of 64 through
`paddle.io.DataLoader(persistent_workers=True)` onto the card. Prints the
time of one image's transforms in-process, then for each worker count the
mean milliseconds between batches of an epoch after its first batch (the
consumer does nothing else) and the first batch's seconds (the spawn).

The second epoch of each worker count is split. Each worker times, a batch,
its 64 samples (read and transforms), the collate and the `out_q.put`, on
the wall clock and in its process's CPU time (all its threads, so the
queue's feeder thread that pickles the batch into the pipe is in it). The
consumer times `_MPWorkerPool._get` (the wait for the worker and the pipe's
read), the unpickling inside it and `_PinnedRing.place` (the copy into a
pinned slot and the H2D copy's launch). On one clock: when the workers'
last put returned and when the consumer took the epoch's last batch, and
the workers' busy share of the epoch. Beside them: the cores the process
may run on, the cgroup's cpu.max where it can be read, and the time one
batch's bytes take through a `multiprocessing` queue from a process that
has already put them (the pipe alone)."""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


# the batch being built in this process: its samples' summed wall and CPU
# seconds and the wall and CPU time its first sample began
BATCH = dict(samples=[0.0, 0.0], start=None)


def _times():
    return time.perf_counter(), time.process_time()


class TimedSamples:
    """The dataset with each sample's read and transforms timed into BATCH."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        w0, c0 = _times()
        if BATCH["start"] is None:
            BATCH["start"] = (w0, c0)
        out = self.ds[i]
        w1, c1 = _times()
        BATCH["samples"][0] += w1 - w0
        BATCH["samples"][1] += c1 - c0
        return out


class TimedWorker:
    """worker_init_fn: wraps this worker's collate and its queues' `put`, and
    appends one JSON line a batch to <out_dir>/worker<w>.jsonl: the samples',
    the collate's and the put's wall and CPU seconds and the batch's whole
    (its first sample's start to its put's return; the wait for the next
    task is outside it); <out_dir>/worker<w>.json holds the worker's torch
    threads, allowed cores and CUDA state."""

    def __init__(self, out_dir):
        self.out_dir = out_dir

    def __call__(self, w):
        import multiprocessing.queues as mpq

        import paddle_tpu_torch.io as pio

        path = os.path.join(self.out_dir, f"worker{w}.jsonl")
        rec, collate = {}, pio._collate_np

        def timed_collate(batch):
            rec["samples"] = BATCH["samples"]
            BATCH["samples"] = [0.0, 0.0]
            w0, c0 = _times()
            out = collate(batch)
            w1, c1 = _times()
            rec["collate"] = [w1 - w0, c1 - c0]
            return out

        put = mpq.Queue.put

        def timed_put(q, obj, *a, **kw):
            w0, c0 = _times()
            put(q, obj, *a, **kw)
            w1, c1 = _times()
            if isinstance(obj, tuple) and obj[0] == "ok":
                start, BATCH["start"] = BATCH["start"], None
                rec.update(put=[w1 - w0, c1 - c0], batch=[w1 - start[0], c1 - start[1]],
                           end=time.time())
                with open(path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                rec.clear()

        pio._collate_np = timed_collate
        mpq.Queue.put = timed_put
        with open(os.path.join(self.out_dir, f"worker{w}.json"), "w") as f:
            json.dump(dict(torch_threads=torch.get_num_threads(),
                           cores=len(os.sched_getaffinity(0)),
                           cuda_initialized=torch.cuda.is_initialized()), f)


class ConsumerTimes:
    """Wraps, in this process, `_MPWorkerPool._get`, the unpickling in
    `multiprocessing.queues` and `_PinnedRing.place`, summing wall seconds
    and counts while `on`."""

    def __init__(self):
        import multiprocessing.queues as mpq

        import paddle_tpu_torch.io as pio

        self.on, self.acc = False, {"get": [0.0, 0], "unpickle": [0.0, 0], "place": [0.0, 0]}
        self.last_get = None  # time.time() of the last `get` that returned while on
        timed = self._timed
        pio._MPWorkerPool._get = timed("get", pio._MPWorkerPool._get)
        pio._PinnedRing.place = timed("place", pio._PinnedRing.place)
        pickler = mpq._ForkingPickler

        class Pickler:
            dumps = staticmethod(pickler.dumps)
            loads = staticmethod(timed("unpickle", pickler.loads))

        mpq._ForkingPickler = Pickler

    def _timed(self, key, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if self.on:
                    self.acc[key][0] += time.perf_counter() - t
                    self.acc[key][1] += 1
                    if key == "get":
                        self.last_get = time.time()

        return call

    def take(self, batches) -> dict:
        """Each part's ms a batch over `batches` batches, and its calls."""
        out = {k: dict(ms_a_batch=s / batches * 1e3, calls=n) for k, (s, n) in self.acc.items()}
        for v in self.acc.values():
            v[:] = [0.0, 0]
        return out


def _pipe_sender(q, ready, nbytes, n):
    """Put n arrays of nbytes into q, then set ready (the queue's feeder
    thread holds them until the reader takes them)."""
    for i in range(n):
        q.put(np.full(nbytes // 4, i, np.float32))
    ready.set()


def pipe_ms(nbytes, n=4) -> dict:
    """ms a `get` of one nbytes array through a spawned process's
    multiprocessing queue, after the sender has put all n: the pipe's read
    and the unpickling, with no wait for a producer."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q, ready = ctx.Queue(), ctx.Event()
    p = ctx.Process(target=_pipe_sender, args=(q, ready, nbytes, n), daemon=True)
    p.start()
    ready.wait(timeout=120)
    time.sleep(0.5)  # the feeder has pickled the first array and blocks on the pipe
    times = []
    for _ in range(n):
        t = time.perf_counter()
        q.get()
        times.append(time.perf_counter() - t)
    p.join(timeout=10)
    ms = float(np.mean(times) * 1e3)
    return dict(bytes=nbytes, ms_each=ms, mb_per_s=nbytes / ms / 1e3, each_ms=[t * 1e3 for t in times])


def cgroup_cpu_max():
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            return f.read().strip()
    except OSError as e:
        return f"unreadable: {type(e).__name__}"


def epoch_ms(loader) -> tuple:
    gaps, t = [], time.perf_counter()
    for _ in loader:
        now = time.perf_counter()
        gaps.append(now - t)
        t = now
    return float(np.mean(gaps[1:]) * 1e3), gaps[0]


def worker_split(out_dir, nw) -> dict:
    """The workers' per-batch records of the split epoch, averaged: ms a
    batch on the wall and in CPU time for each part."""
    rows, info = [], []
    for w in range(nw):
        with open(os.path.join(out_dir, f"worker{w}.jsonl")) as f:
            rows += [json.loads(line) for line in f]
        with open(os.path.join(out_dir, f"worker{w}.json")) as f:
            info.append(json.load(f))
    mean = lambda k, j: float(np.mean([r[k][j] for r in rows]) * 1e3)
    parts = {k: dict(wall_ms=mean(k, 0), cpu_ms=mean(k, 1))
             for k in ("samples", "collate", "put", "batch")}
    parts["cpu_share_of_wall"] = parts["batch"]["cpu_ms"] / parts["batch"]["wall_ms"]
    return dict(parts, batches=len(rows), workers=info, last_end=max(r["end"] for r in rows))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", default="1,4,7")
    ap.add_argument("--images", type=int, default=704)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "dataloader_scaling.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dataloader_scaling: CUDA is not available", file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt

    ptt.set_device("cuda")
    consumer = ConsumerTimes()
    T = ptt.vision.transforms
    tf = T.Compose([T.RandomResizedCrop(cs.MBV3_CROP), T.RandomHorizontalFlip(),
                    T.Normalize(cs.IMAGENET_MEAN, cs.IMAGENET_STD, data_format="HWC"),
                    T.Transpose()])
    report = dict(cpu_count=os.cpu_count(), cores=len(os.sched_getaffinity(0)),
                  cgroup_cpu_max=cgroup_cpu_max(), runs={})
    with tempfile.TemporaryDirectory(prefix="dl_scaling_") as work:
        ds = cs.ColourClassImages(os.path.join(work, "train.npy"), args.images, 0, tf)
        img = np.asarray(np.load(ds.path, mmap_mode="r")[0])
        t = time.perf_counter()
        for _ in range(50):
            tf(img)
        report["transforms_ms_in_process"] = (time.perf_counter() - t) / 50 * 1e3
        print(f"one image's transforms in-process: {report['transforms_ms_in_process']:.2f} ms "
              f"(cpu_count {os.cpu_count()}, cores {report['cores']}, cpu.max "
              f"{report['cgroup_cpu_max']})", flush=True)
        for nw in (int(w) for w in args.workers.split(",")):
            out_dir = os.path.join(work, f"w{nw}")
            os.makedirs(out_dir)
            samples = TimedSamples(ds)
            loader = ptt.io.DataLoader(samples, batch_size=cs.MBV3_BATCH, shuffle=True,
                                       drop_last=True, num_workers=nw, persistent_workers=True,
                                       worker_init_fn=TimedWorker(out_dir))
            first = epoch_ms(loader)
            for w in range(nw):  # keep only the split epoch's records
                open(os.path.join(out_dir, f"worker{w}.jsonl"), "w").close()
            t0, c0 = time.time(), time.process_time()
            consumer.on = True
            second = epoch_ms(loader)
            consumer.on = False
            epoch_s, c1 = consumer.last_get - t0, time.process_time()
            loader._shutdown_workers()
            wk = worker_split(out_dir, nw)
            run = dict(first_epoch_ms=first[0], first_batch_s=first[1], ms_per_batch=second[0],
                       first_batch_s_again=second[1], worker=wk,
                       consumer=consumer.take(len(loader)), consumer_cpu_s=c1 - c0,
                       epoch_s=epoch_s, workers_last_put_s=wk.pop("last_end") - t0,
                       workers_busy_share=wk["batch"]["wall_ms"] * wk["batches"] / 1e3
                       / (nw * epoch_s))
            report["runs"][nw] = run
            wk = run["worker"]
            print(f"workers {nw}: {first[0]:.1f} ms a batch (first batch {first[1]:.2f} s), "
                  f"again {second[0]:.1f} ms; a worker's batch: samples "
                  f"{wk['samples']['wall_ms']:.1f} ms wall / {wk['samples']['cpu_ms']:.1f} cpu, "
                  f"collate {wk['collate']['wall_ms']:.1f}, put {wk['put']['wall_ms']:.1f}, "
                  f"whole {wk['batch']['wall_ms']:.1f} wall / "
                  f"{wk['batch']['cpu_ms']:.1f} cpu; consumer a batch: get "
                  f"{run['consumer']['get']['ms_a_batch']:.1f} ms (unpickle "
                  f"{run['consumer']['unpickle']['ms_a_batch']:.1f}), place "
                  f"{run['consumer']['place']['ms_a_batch']:.1f}; the workers' last put at "
                  f"{run['workers_last_put_s']:.2f} s of the epoch's {epoch_s:.2f} s, busy "
                  f"{run['workers_busy_share']:.3f}", flush=True)
        report["pipe"] = pipe_ms(cs.MBV3_BATCH * 3 * cs.MBV3_CROP * cs.MBV3_CROP * 4)  # f32 CHW
        print(f"one batch's {report['pipe']['bytes']} bytes through a queue from a process that "
              f"put them: {report['pipe']['ms_each']:.1f} ms ({report['pipe']['mb_per_s']:.1f} "
              f"MB/s)", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"written: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
