"""The card's energy counter and clocks through NVML, and the ``Trainer``'s
measured energy meter.

:class:`Nvml` reads NVIDIA's management library by ``ctypes``;
:class:`NvmlStepMeter` is the ``Trainer``'s ``energy_meter=`` (the hook
the reference's modeled ``runtime.energy.EnergyMeter`` plugs into), each
step's reading the joules and wall seconds the counter saw since the last.
Nothing here sets a clock.  Without the library or the card, ``Nvml()``
raises.
"""
from __future__ import annotations

import dataclasses
import time

import torch


class Nvml:
    """The card's counters through NVML by ``ctypes`` (``libnvidia-ml.so.1``,
    installed with the card's NVIDIA software): name, power limit, supported
    and current clocks, power draw and the energy counter (a running total
    in mJ).  The device is the one CUDA calls 0, found by its UUID.  A
    missing library, function or device raises; an energy read below the
    last one raises."""

    CLOCK_SM, CLOCK_MEM = 1, 2

    def __init__(self):
        import ctypes as c
        self.c = c
        lib = c.CDLL("libnvidia-ml.so.1")
        u, p = c.c_uint, c.POINTER
        dev = c.c_void_p
        for name, args in (
                ("nvmlInit_v2", []), ("nvmlShutdown", []),
                ("nvmlDeviceGetCount_v2", [p(u)]),
                ("nvmlDeviceGetHandleByIndex_v2", [u, p(dev)]),
                ("nvmlDeviceGetName", [dev, c.c_char_p, u]),
                ("nvmlDeviceGetUUID", [dev, c.c_char_p, u]),
                ("nvmlDeviceGetPowerManagementLimit", [dev, p(u)]),
                ("nvmlDeviceGetPowerUsage", [dev, p(u)]),
                ("nvmlDeviceGetClockInfo", [dev, c.c_int, p(u)]),
                ("nvmlDeviceGetSupportedMemoryClocks", [dev, p(u), p(u)]),
                ("nvmlDeviceGetSupportedGraphicsClocks", [dev, u, p(u), p(u)]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [dev, p(c.c_ulonglong)])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, c.c_int
        lib.nvmlErrorString.argtypes = [c.c_int]
        lib.nvmlErrorString.restype = c.c_char_p
        self.lib = lib
        self._call("nvmlInit_v2")
        want = str(torch.cuda.get_device_properties(0).uuid).lower()
        count = u()
        self._call("nvmlDeviceGetCount_v2", c.byref(count))
        self.handle = None
        for i in range(count.value):
            h = dev()
            self._call("nvmlDeviceGetHandleByIndex_v2", u(i), c.byref(h))
            if self._text("nvmlDeviceGetUUID", h).lower() \
                    .removeprefix("gpu-") == want.removeprefix("gpu-"):
                self.handle = h
        if self.handle is None:
            raise RuntimeError(f"NVML lists no device with CUDA device 0's "
                               f"UUID {want} ({count.value} devices)")
        self.last_mj = 0

    def _call(self, name, *args):
        ret = getattr(self.lib, name)(*args)
        if ret != 0:
            raise RuntimeError(f"{name}: NVML error {ret} "
                               f"({self.lib.nvmlErrorString(ret).decode()})")

    def _text(self, name, handle):
        buf = self.c.create_string_buffer(96)
        self._call(name, handle, buf, self.c.c_uint(96))
        return buf.value.decode()

    def _uint(self, name, *args):
        out = self.c.c_uint()
        self._call(name, self.handle, *args, self.c.byref(out))
        return out.value

    def name(self) -> str:
        return self._text("nvmlDeviceGetName", self.handle)

    def power_limit_w(self) -> float:
        return self._uint("nvmlDeviceGetPowerManagementLimit") / 1e3

    def power_w(self) -> float:
        return self._uint("nvmlDeviceGetPowerUsage") / 1e3

    def clocks_mhz(self):
        """(SM clock, memory clock) now, in MHz."""
        return (self._uint("nvmlDeviceGetClockInfo", self.CLOCK_SM),
                self._uint("nvmlDeviceGetClockInfo", self.CLOCK_MEM))

    def _list(self, name, *args):
        n = self.c.c_uint(512)
        buf = (self.c.c_uint * 512)()
        self._call(name, self.handle, *args, self.c.byref(n), buf)
        return sorted(buf[i] for i in range(n.value))

    def supported_clocks(self) -> dict:
        """{memory clock: [graphics clocks supported at it]}, ascending."""
        return {m: self._list("nvmlDeviceGetSupportedGraphicsClocks",
                              self.c.c_uint(m))
                for m in self._list("nvmlDeviceGetSupportedMemoryClocks")}

    def energy_j(self) -> float:
        """The energy counter in joules, read after the device's queued
        work is done; raises if it went backwards."""
        torch.cuda.synchronize()
        out = self.c.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", self.handle,
                   self.c.byref(out))
        if out.value < self.last_mj:
            raise AssertionError(f"NVML energy counter decreased: "
                                 f"{out.value} mJ after {self.last_mj} mJ")
        self.last_mj = out.value
        return out.value / 1e3

    def close(self) -> None:
        self._call("nvmlShutdown")


@dataclasses.dataclass
class StepReading:
    step: int
    time_s: float
    energy_j: float
    clocks: tuple                 # (SM, memory) MHz at the read


class NvmlStepMeter:
    """The ``Trainer``'s ``energy_meter``: at each ``on_step`` (after the
    trainer has waited for the step's loss) the stream is synchronised and
    the energy counter read; a step's reading is the joules and wall
    seconds since the previous one (step 0's since construction)."""

    def __init__(self, nvml):
        self.nvml = nvml
        self.records = []
        self.last = (nvml.energy_j(), time.perf_counter())

    def on_step(self, step):
        now = (self.nvml.energy_j(), time.perf_counter())
        rec = StepReading(step, now[1] - self.last[1], now[0] - self.last[0],
                          self.nvml.clocks_mhz())
        self.last = now
        self.records.append(rec)
        return rec

    def totals(self):
        return {"steps": len(self.records),
                "time_s": sum(r.time_s for r in self.records),
                "energy_j": sum(r.energy_j for r in self.records)}


__all__ = ["Nvml", "StepReading", "NvmlStepMeter"]
