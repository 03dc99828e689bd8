"""The trace reduction on synthetic profiler events: busy time, kernel time
by name, idle time charged to what the host was doing."""

import pytest

from qbench.tracing import summarize


class Ev:
    def __init__(self, name, dev, start_us, end_us):
        self._n, self._d = name, dev
        self._s, self._e = int(start_us * 1000), int(end_us * 1000)

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


def test_summary_of_two_steps():
    ev = [
        Ev("qbench.trace", "CPU", 0, 1000),
        Ev("qbench.step", "CPU", 100, 500),
        Ev("qbench.schedule", "CPU", 100, 150),
        Ev("qbench.execute", "CPU", 150, 450),
        Ev("qbench.step", "CPU", 600, 900),
        Ev("qbench.execute", "CPU", 620, 880),
        Ev("qbench.step", "CUDA", 100, 500),  # a device-side annotation: not an operation
        Ev("aten::mm", "CPU", 200, 210),  # host ops never count as busy
        Ev("void w4a8_gemm_per_chn_wgmma_kernel<1>()", "CUDA", 200, 300),
        Ev("void paged_decode_kernel<4>()", "CUDA", 250, 400),  # overlaps the GEMM
        Ev("void w4a8_gemm_per_chn_wgmma_kernel<1>()", "CUDA", 700, 800),
        Ev("Memcpy HtoD (Pinned -> Device)", "CUDA", 650, 660),
        Ev("void late_kernel()", "CUDA", 990, 1100),  # clipped to the window
    ]
    s = summarize(ev, ["decode", "mixed"])
    assert s.window_s == pytest.approx(1000e-6)
    # busy: [200, 400] + [650, 660] + [700, 800] + [990, 1000]
    assert s.busy_s == pytest.approx(320e-6)
    assert s.device_s(("w4a8_gemm_per_chn",)) == pytest.approx(200e-6)
    assert s.device_s(("paged_decode",)) == pytest.approx(150e-6)
    idle = s.idle_by_label
    assert sum(idle.values()) == pytest.approx(s.window_s - s.busy_s)
    # gaps: [0, 200] [400, 650] [660, 700] [800, 990]
    assert idle["harness"] == pytest.approx((100 + 100 + 90) * 1e-6)
    assert idle["schedule"] == pytest.approx(50e-6)
    assert idle["execute.decode"] == pytest.approx((50 + 50) * 1e-6)
    assert idle["engine.decode"] == pytest.approx(50e-6)
    assert idle["engine.mixed"] == pytest.approx((20 + 20 + 0) * 1e-6 + 0)
    assert idle["execute.mixed"] == pytest.approx((30 + 40 + 80) * 1e-6)
    assert s.top_ops(1)[0][0].startswith("void w4a8_gemm")
