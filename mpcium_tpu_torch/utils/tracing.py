"""Phase timing for the engines.

:class:`PhaseTimer` closes one wall-clock interval per protocol phase.
It is off unless the caller passes a ``phase_times`` dict; when on, each
``mark`` synchronizes the device first (``torch.cuda.synchronize``), so
a phase's seconds include the device work queued during it. Off, a mark
is one attribute load — no sync, nothing recorded.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    __slots__ = ("on", "phases", "device", "last")

    def __init__(self, device: torch.device,
                 phase_times: Optional[Dict[str, float]] = None) -> None:
        self.on = phase_times is not None
        self.phases = phase_times
        self.device = device
        self.last = time.perf_counter() if self.on else 0.0

    def mark(self, name: str) -> None:
        if not self.on:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + (t - self.last)
        self.last = t
