"""The traced run's reduction: busy time, idle time by host span, the
device operations that took most time."""
from harness.tracing import Hooks, summarize_trace


class Ev:
    def __init__(self, name, start, dur, device="DeviceType.CUDA",
                 kind="kernel"):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._k = device, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def activity_type(self):
        return self._k


def test_summarize_trace():
    events = [Ev("k1", 10, 10), Ev("k1", 15, 10),      # busy 10..25
              Ev("copy", 60, 20, kind="gpu_memcpy"),  # busy 60..80
              Ev("cudaLaunchKernel", 0, 100, device="DeviceType.CPU",
                 kind="cuda_runtime"),
              Ev("late", 95, 20)]                      # clipped to 95..100
    spans = [("prep", 0, 40), ("candgen", 40, 50), ("level_program", 50, 70),
             ("schedule", 52, 55)]
    s = summarize_trace(events, 0, 100, spans)
    assert s["window_s"] == 100e-9
    assert s["busy_s"] == (15 + 20 + 5) * 1e-9
    idle = {k: round(v * 1e9) for k, v in s["idle_gaps"]}
    # gaps 0..10, 25..60, 80..95: prep 10 + 15, candgen 10, level_program
    # 7 (50..52, 55..60), schedule 3, other 15 (80..95)
    assert idle == {"prep": 25, "candgen": 10, "level_program": 7,
                    "schedule": 3, "other": 15}
    ops = {k: round(v * 1e9) for k, v in s["device_ops"]}
    assert ops == {"k1": 20, "copy": 20, "late": 5}


def test_hooks_patch_and_restore():
    class Owner:
        @staticmethod
        def f(x):
            return x + 1

    hooks = Hooks()
    hooks.patch(Owner, "f", lambda fn: (lambda x: fn(x) * 10))
    assert Owner.f(1) == 20
    hooks.restore()
    assert Owner.f(1) == 2
