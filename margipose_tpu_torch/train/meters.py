"""Metrics aggregation and fan-out (telemetry).

Reimplements the capability surface of the reference's external ``tele``
dependency (reference: src/margipose/bin/train_3d.py:36-116): named meters
aggregated per epoch and fanned out to sinks (console, JSONL file,
TensorBoard if available).
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from os import path


class ValueMeter:
    def __init__(self, skip_reset=False):
        self.skip_reset = skip_reset
        self._value = None

    def set_value(self, v):
        self._value = v

    def add(self, v):
        self._value = v

    def value(self):
        return self._value

    def reset(self):
        if not self.skip_reset:
            self._value = None


class MeanValueMeter:
    def __init__(self):
        self._sum = 0.0
        self._n = 0

    def add(self, v, n=1):
        self._sum += float(v) * n
        self._n += n

    def value(self):
        return self._sum / self._n if self._n else None

    def reset(self):
        self._sum, self._n = 0.0, 0


class MedianValueMeter:
    def __init__(self):
        self._values = []

    def add(self, v):
        self._values.append(float(v))

    def value(self):
        if not self._values:
            return None
        vs = sorted(self._values)
        n = len(vs)
        return vs[n // 2] if n % 2 else 0.5 * (vs[n // 2 - 1] + vs[n // 2])

    def reset(self):
        self._values = []


class Telemetry:
    """Meter registry with sinks flushed on ``step()``
    (mirrors tele.Telemetry usage at src/margipose/bin/train_3d.py:63,384)."""

    def __init__(self, meters: dict):
        self.meters = dict(meters)
        self.sinks = []
        self.epoch = 0

    def __getitem__(self, name):
        return self.meters[name]

    def sink(self, fn):
        self.sinks.append(fn)

    def step(self):
        values = {
            k: m.value() for k, m in self.meters.items() if m.value() is not None
        }
        for sink in self.sinks:
            sink(self.epoch, values)
        for m in self.meters.values():
            m.reset()
        self.epoch += 1


def console_sink(keys=None):
    def sink(epoch, values):
        shown = {k: v for k, v in values.items() if keys is None or k in keys}
        parts = []
        for k, v in shown.items():
            if isinstance(v, float):
                parts.append(f"{k}={v:.6g}")
            elif isinstance(v, (int, str)):
                parts.append(f"{k}={v}")
        print(f"[epoch {epoch}] " + "  ".join(parts), flush=True)

    return sink


def jsonl_sink(out_file):
    def sink(epoch, values):
        record = {"epoch": epoch, "time": time.time()}
        for k, v in values.items():
            if isinstance(v, (int, float, str)):
                record[k] = v
        with open(out_file, "a") as f:
            f.write(json.dumps(record) + "\n")

    return sink


def tensorboard_sink(log_dir):
    """TensorBoard scalar sink (optional; no-op when TB isn't installed)."""
    try:
        from torch.utils.tensorboard import SummaryWriter  # torch is baked in

        writer = SummaryWriter(log_dir)
    except Exception:
        return lambda epoch, values: None

    def sink(epoch, values):
        for k, v in values.items():
            if isinstance(v, (int, float)):
                writer.add_scalar(k, v, epoch)
        writer.flush()

    return sink


@contextmanager
def timer(meter):
    """Phase timer feeding a meter
    (reference: src/margipose/utils.py:218-226)."""
    start = time.perf_counter()
    yield
    meter.add(time.perf_counter() - start)


def generator_timer(iterable, meter):
    """Times each ``next()`` of the iterable
    (reference: src/margipose/utils.py:229-234)."""
    it = iter(iterable)
    while True:
        try:
            with timer(meter):
                value = next(it)
            yield value
        except StopIteration:
            return


def make_train_reporter(with_val=True, out_dir=None):
    """The standard meter registry
    (reference: src/margipose/bin/train_3d.py:39-61)."""
    meters = {
        "epoch": ValueMeter(),
        "data_load_time": MeanValueMeter(),
        "data_transfer_time": MeanValueMeter(),
        "forward_time": MeanValueMeter(),
        "backward_time": MeanValueMeter(),
        "optim_time": MeanValueMeter(),
        "eval_time": MeanValueMeter(),
        "step_time": MeanValueMeter(),
        "train_loss": MeanValueMeter(),
        "train_mpjpe": MeanValueMeter(),
        "train_pck": MeanValueMeter(),
        "train_images_per_sec": MeanValueMeter(),
        # schedule values applied by the epoch's last optimiser step
        # (train.schedules.schedule_values) — lets a soak/production run
        # verify the 1cycle trajectory endpoints from the recorded metrics
        "lr": ValueMeter(),
        "momentum": ValueMeter(),
    }
    if with_val:
        meters.update({
            "val_loss": MeanValueMeter(),
            "val_mpjpe": MeanValueMeter(),
            "val_pck": MeanValueMeter(),
        })
    tel = Telemetry(meters)
    keys = ["train_loss", "train_mpjpe", "train_pck", "train_images_per_sec",
            "step_time"]
    if with_val:
        keys += ["val_loss", "val_mpjpe", "val_pck"]
    tel.sink(console_sink(keys))
    if out_dir:
        tel.sink(jsonl_sink(path.join(out_dir, "metrics.jsonl")))
        tel.sink(tensorboard_sink(path.join(out_dir, "tb")))
    return tel
